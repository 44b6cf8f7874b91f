"""The comparison that decides ``correct``.

After the window: every request the comparison covers must have
committed exactly the tokens its traffic asked for (no EOS stops one),
and a sample drawn from the seed of the finished requests, the longest
among them, is served again by the plain reference from its prompt and
its served tokens; enough requests and greedy tokens must be compared.
Each run reads six numbers, and compares those its cell's file names
(``check.compare``), each with its limit (``limits``), of these six:

* ``gap`` / ``gap_mean``: the widest / the mean gap, over every compared
  token, by which a served token's logit lies below the lowest that the
  reference keeps at its position: for a greedy request the best alone,
  for a sampled one the lowest tempered, penalised logit that the
  reference's filters keep;
* ``greedy_gap`` / ``greedy_gap_mean``, ``kept_gap`` / ``kept_gap_mean``:
  the same over the greedy and over the sampled requests' tokens alone.

With ``control`` the fp8 control is read at the same positions and
judged by the same rule and limits in the program's place
(``control_correct``): the comparison must find it not correct.
"""
from __future__ import annotations

import sys
from typing import Dict, List

import numpy as np

from perfbench import reference

#: the numbers each run reads; a cell's file names those it compares
NUMBERS = ("gap", "gap_mean", "greedy_gap", "greedy_gap_mean", "kept_gap",
           "kept_gap_mean")
#: the counts that must reach their limit, not stay under it
AT_LEAST = ("compared_requests", "greedy_tokens")


def _bucket(n: int, mult: int) -> int:
    return max(mult, -(-n // mult) * mult)


def padded_lengths(served, bucket: int, max_seq: int) -> Dict[int, int]:
    """{request id: the length its admission call padded prompts to}: the
    longest prompt admitted in the same scheduler step, rounded up to the
    bucket (the program's monolithic prefill pads a call to that)."""
    longest: Dict[int, int] = {}
    for s in served:
        r = s.request
        if r.admit_step >= 0:
            longest[r.admit_step] = max(longest.get(r.admit_step, 0),
                                        len(r.prompt))
    return {s.request.request_id: min(_bucket(longest[s.request.admit_step],
                                              bucket), max_seq)
            for s in served if s.request.admit_step >= 0}


def sample(candidates, seed: int, greedy: int, sampled: int) -> List:
    """The longest candidate, then up to ``greedy`` greedy and
    ``sampled`` sampled ones, drawn from the seed."""
    if not candidates:
        return []
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, 0xC4EC])
    longest = max(candidates, key=lambda s: len(s.request.output))
    rest = [s for s in candidates if s is not longest]
    order = [rest[i] for i in rng.permutation(len(rest))]
    g = [s for s in order if s.spec.greedy][:greedy]
    p = [s for s in order if not s.spec.greedy][:sampled]
    return [longest] + g + p


def complete(s) -> bool:
    r = s.request
    return len(r.output) == s.spec.max_new and r.finish_reason == "length"


def judge(cell, weights, log, seed: int, control: bool = False) -> dict:
    """Readings, limits and the verdict of one run (and with ``control``
    the control's readings, compared numbers and verdict)."""
    chk = cell.settings["check"]
    cfg = cell.config
    reference.check_config(cfg)
    open_loop = cell.traffic["kind"] == "open_loop"
    if open_loop:
        covered = [s for s in log.served if log.ws <= s.due < log.we]
    else:
        covered = [s for s in log.served if s.request.should_stop()]
    unfinished = sum(1 for s in covered if not s.request.should_stop())
    wrong = sum(1 for s in covered
                if s.request.should_stop() and not complete(s))
    # the finished requests, and at saturation also the tokens committed
    # so far of those still running when the window closed
    candidates = [s for s in covered if complete(s)] if open_loop else \
        [s for s in log.served if s.request.output and
         (complete(s) or not s.request.should_stop())]
    picked = sample(candidates, seed, chk["greedy"], chk["sampled"])
    pads = padded_lengths(log.served, cfg.get("prompt_bucket", 1),
                          cell.settings["engine"]["max_seq_len"])
    items = [dict(prompt=s.request.prompt, outputs=s.request.output,
                  padded=pads.get(s.request.request_id, 0),
                  contract=s.spec.contract, greedy=s.spec.greedy)
             for s in picked]
    reference.no_tf32()
    res = reference.request_readings(cfg, weights, items, control=control,
                                     seed=seed)
    greedy_tokens = sum(len(i["outputs"]) for i in items if i["greedy"])
    limits = cell.settings.get("limits") or {}
    counts = {"unfinished": (unfinished, 0), "wrong_length": (wrong, 0),
              "compared_requests": (len(items), chk["min_requests"]),
              "greedy_tokens": (greedy_tokens, chk["min_greedy_tokens"])}
    counts_ok = (unfinished == 0 and wrong == 0
                 and len(items) >= chk["min_requests"]
                 and greedy_tokens >= chk["min_greedy_tokens"])

    def verdict(readings: dict):
        compared = dict(counts)
        for k in chk["compare"]:
            compared[k] = (readings[k], limits.get(k))
        ok = counts_ok and all(limits.get(k) is not None
                               and readings[k] <= limits[k]
                               for k in chk["compare"])
        return bool(ok), {k: {"value": v, "limit": lim}
                          for k, (v, lim) in compared.items()}

    readings = {k: res[k] for k in NUMBERS}
    out = {"attempted": len(covered), "failed": unfinished + wrong,
           "requests_compared": len(items),
           "tokens_compared": sum(len(i["outputs"]) for i in items),
           "greedy_tokens": greedy_tokens, "readings": readings}
    out["correct"], out["compared"] = verdict(readings)
    if control:
        out["control"] = {k: res[k + "_control"] for k in NUMBERS}
        out["control_correct"], out["control_compared"] = \
            verdict(out["control"])
    return out


def print_compared(compared: dict, stream=sys.stderr) -> None:
    """Each number compared beside its limit, one a line."""
    for k, d in compared.items():
        rel = ">=" if k in AT_LEAST else "<="
        print(f"check {k}: {d['value']!r} (limit {rel} {d['limit']!r})",
              file=stream)
