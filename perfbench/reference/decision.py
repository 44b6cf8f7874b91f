"""The decision plane's semantics, plainly: penalties, temperature and
the top-k, nucleus and min-p filters over the whole vocabulary.

  repetition  f = 1 + (rep - 1) [token in prompt or output]
              z = z / f where z > 0, z * f elsewhere
  presence    z -= pres [token in output]
  frequency   z -= freq * count in output
  temperature z / max(T, 1e-6); greedy takes argmax z
  top-k       the k best (equal values: the lower id first)
  top-p       the smallest prefix of the top-k distribution, by
              probability, whose exclusive prefix mass is below p
  min-p       probability >= min_p x the top-k distribution's largest

Readings, per served token, of the reference's logits at its position:

* greedy: how far the served token's logit lies below the best;
* sampled: how far the served token's tempered logit lies below the
  lowest one that the filters keep (0 inside the kept set);

each summed up over a run's compared tokens as the widest gap and the
mean gap, of each kind and of both together (a greedy token's kept set
is the best token alone, so one gap reads both kinds).

The control reads the same at the same positions, of the token that it
would serve there: the one its own logits put first (greedy), or one
drawn from its own filtered distribution with the uniforms given
(sampled).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch


def output_counts(prompt_len: int, outputs: torch.Tensor, V: int
                  ) -> torch.Tensor:
    """(n, V) int32: row j counts outputs[:j] (the history at output
    position j)."""
    n = outputs.shape[0]
    oh = torch.zeros((n, V), dtype=torch.int32, device=outputs.device)
    if n > 1:
        oh[torch.arange(1, n, device=outputs.device), outputs[:-1]] = 1
    return oh.cumsum(0, dtype=torch.int32)


def penalize(logits: torch.Tensor, prompt: torch.Tensor,
             counts: torch.Tensor, c: dict) -> torch.Tensor:
    """Penalised logits (n, V) of rows whose histories are ``counts``."""
    V = logits.shape[-1]
    in_prompt = torch.zeros(V, dtype=torch.bool, device=logits.device)
    in_prompt[prompt] = True
    z = logits.float()
    rep = c.get("repetition_penalty", 1.0)
    seen = (in_prompt[None] | (counts > 0)).float()
    f = 1.0 + (rep - 1.0) * seen
    z = torch.where(z > 0, z / f, z * f)
    z = z - c.get("presence_penalty", 0.0) * (counts > 0).float()
    z = z - c.get("frequency_penalty", 0.0) * counts.float()
    return z


def kept(zt: torch.Tensor, c: dict) -> torch.Tensor:
    """(n, V) bool: the tokens the filters keep, of tempered logits."""
    n, V = zt.shape
    order = torch.sort(zt, dim=-1, descending=True, stable=True).indices
    ranks = torch.empty_like(order).scatter_(
        1, order, torch.arange(V, device=zt.device).expand(n, V))
    k = c.get("top_k", 0) or V
    mask = ranks < k
    probs = torch.softmax(zt.masked_fill(~mask, float("-inf")), -1)
    sp = probs.gather(1, order)
    keep_sorted = (sp.cumsum(-1) - sp) < c.get("top_p", 1.0)
    mask &= torch.empty_like(keep_sorted).scatter_(1, order, keep_sorted)
    mask &= probs >= c.get("min_p", 0.0) * probs.amax(-1, keepdim=True)
    return mask


def draw(zt: torch.Tensor, keep: torch.Tensor, u: torch.Tensor
         ) -> torch.Tensor:
    """Inverse-CDF draws (n,) from the kept tokens' softmax."""
    p = torch.softmax(zt.masked_fill(~keep, float("-inf")), -1)
    cdf = p.cumsum(-1)
    idx = (cdf <= u[:, None] * cdf[:, -1:]).sum(-1)
    return idx.clamp(max=zt.shape[-1] - 1)


def readings(ref: torch.Tensor, served: torch.Tensor, prompt: torch.Tensor,
             c: dict, greedy: bool, control: Optional[torch.Tensor] = None,
             u: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The gap at each served token of one request (and at the token the
    control would serve, given its logits ``control`` at the same
    positions and the (n,) uniforms ``u`` of its draws): ``{"greedy":
    gaps}`` or ``{"kept": gaps}``, and ``<kind>_control``. ``ref``: (n,
    V) reference logits at the n output positions."""
    counts = output_counts(len(prompt), served, ref.shape[-1])
    z = penalize(ref, prompt, counts, c)
    rows = torch.arange(served.shape[0], device=ref.device)
    if greedy:
        best = z.amax(-1)
        out = {"greedy": best - z[rows, served]}
        if control is not None:
            zc = penalize(control, prompt, counts, c)
            out["greedy_control"] = best - z[rows, zc.argmax(-1)]
        return out
    T = max(c.get("temperature", 1.0), 1e-6)
    zt = z / T
    edge = zt.masked_fill(~kept(zt, c), float("inf")).amin(-1)
    out = {"kept": (edge - zt[rows, served]).clamp(min=0)}
    if control is not None:
        zct = penalize(control, prompt, counts, c) / T
        tok = draw(zct, kept(zct, c), u)
        out["kept_control"] = (edge - zt[rows, tok]).clamp(min=0)
    return out


def summary(gaps, name: str) -> Dict[str, float]:
    """The widest and the mean of ``gaps`` (every request's tokens):
    ``<name>`` and ``<name>_mean`` (0 with no tokens)."""
    xs = [g for g in gaps if g.numel()]
    if not xs:
        return {name: 0.0, f"{name}_mean": 0.0}
    allg = torch.cat(xs)
    return {name: float(allg.max()), f"{name}_mean": float(allg.mean())}
