"""The one traffic generator: a mix file's parameters and a seed in, a
stream of request specifications out.

Sizes, contracts and inter-arrival gaps come from the mix's
``base_seed`` in blocks of ``block`` requests; the run's seed shuffles
each block and draws the token ids. So every seed offers the same work
block by block, in another order and with other tokens, and a seed
changes the noise of a run, not its load.

Kinds:

* ``open_loop``: Poisson arrivals at ``rate_rps``; requests are due from
  0 on, ``ramp_s`` before the window opens, until the window closes.
* ``saturated``: no schedule; the load loop keeps ``queue`` requests
  waiting. With ``first_batch_residual`` the first ``slots`` requests
  take residual output lengths (a length-biased draw, then a uniform
  point in it), so completions are spread from the start.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class Spec:
    index: int
    due: Optional[float]        # seconds after the traffic's start
    prompt: np.ndarray          # int64 token ids
    max_new: int
    contract: dict              # SamplingConfig keyword arguments
    greedy: bool


def _draw_len(rng: np.random.Generator, d: dict, n: int) -> np.ndarray:
    if d["dist"] == "uniform":
        return rng.integers(d["min"], d["max"] + 1, n)
    if d["dist"] == "lognormal":
        x = d["median"] * np.exp(d["sigma"] * rng.standard_normal(n))
        return np.clip(np.rint(x), d["min"], d["max"]).astype(np.int64)
    raise ValueError(f"unknown length distribution {d['dist']!r}")


def _contract_ids(mix: dict, n: int) -> np.ndarray:
    """Exactly round(share x n) requests of each contract in a block."""
    shares = [c["share"] for c in mix["contracts"]]
    counts = np.floor(np.array(shares) * n + 0.5).astype(int)
    counts[0] += n - counts.sum()
    return np.repeat(np.arange(len(shares)), counts)


def _contract(c: dict) -> dict:
    return {k: v for k, v in c.items() if k != "share"}


def block_plan(mix: dict, block_idx: int):
    """(prompt lengths, output lengths, contract ids, gaps) of one block,
    from the mix's base seed alone."""
    n = mix["block"]
    rng = np.random.default_rng([mix["base_seed"], block_idx])
    plen = _draw_len(rng, mix["prompt"], n)
    olen = _draw_len(rng, mix["output"], n)
    cids = _contract_ids(mix, n)
    gaps = rng.exponential(1.0 / mix["rate_rps"], n) \
        if mix["kind"] == "open_loop" else np.zeros(n)
    return plen, olen, cids, gaps


def residual(rng: np.random.Generator, olen: np.ndarray) -> np.ndarray:
    """Residual lengths of requests caught mid-flight: a length-biased
    pick from ``olen``, then a uniform point in it (at least 1)."""
    p = olen / olen.sum()
    picked = rng.choice(olen, size=len(olen), p=p)
    return np.maximum(1, np.ceil(rng.random(len(olen)) * picked)).astype(
        np.int64)


def generate(mix: dict, seed: int, vocab: int, slots: int = 0
             ) -> Iterator[Spec]:
    """The mix's endless request stream for ``seed``."""
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32])
    t = 0.0
    i = 0
    b = 0
    while True:
        plen, olen, cids, gaps = block_plan(mix, b)
        order = rng.permutation(len(plen))
        plen, olen, cids, gaps = plen[order], olen[order], cids[order], \
            gaps[order]
        k = min(len(olen), slots - i) if mix.get("first_batch_residual") \
            else 0
        if k > 0:
            olen = olen.copy()
            olen[:k] = residual(rng, olen[:k])
        for j in range(len(plen)):
            c = mix["contracts"][cids[j]]
            prompt = rng.integers(1, vocab, int(plen[j]))
            due = None
            if mix["kind"] == "open_loop":
                t += float(gaps[j])
                due = t
            yield Spec(index=i, due=due, prompt=prompt,
                       max_new=int(olen[j]), contract=_contract(c),
                       greedy=bool(c.get("greedy", False)))
            i += 1
        b += 1

