"""Speculative Hot-Vocab Sampling with rejection correctness (paper §5.3).

Math (Eq. 6–9): with penalized/scaled logits z and stable weights
``w_v = exp(z_v − max z)`` split into hot set H and tail V∖H:

    α_b  = S_hot / (S_hot + S_tail)
    q    = w|_H / S_hot          (hot proposal)
    r    = w|_tail / S_tail      (tail proposal)
    draw ŷ ~ q; accept iff u ≤ α_b else y ~ r    ⇒  P[y = v] = p̃_v  exactly.

One O(V) pass gives (m, S_hot, S_tail, tail_max); on a CUDA tensor it is
the ``shvs_masses`` kernel (``kernels/csrc/shvs.cu``). All sort-based work
is confined to the H-sized hot block, except for rows whose filter support
is not provably inside H (the containment guard), which take the
full-vocabulary truncation-first path.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.sampler_backend import (DecisionStats, SamplerBackend,
                                              register_backend)
from repro_torch.core.sampling import (SamplingParams, _inverse_cdf_draw,
                                       temperature_scale, top_k_stable,
                                       truncation_first_sample)

NEG_INF = -1e30


class HotSet(NamedTuple):
    """Model-dependent hot vocabulary (built offline, §5.3)."""

    indices: torch.Tensor   # (H,) int64 — token ids in the hot set
    mask: torch.Tensor      # (V,) bool  — membership mask

    @property
    def size(self) -> int:
        return self.indices.shape[0]


def make_hot_set(indices, vocab_size: int, device="cpu") -> HotSet:
    indices = torch.as_tensor(indices, dtype=torch.int64, device=device)
    mask = torch.zeros((vocab_size,), dtype=torch.bool, device=device)
    mask[indices] = True
    return HotSet(indices=indices, mask=mask)


class SHVSResult(NamedTuple):
    tokens: torch.Tensor      # (B,) int32
    accepted: torch.Tensor    # (B,) bool — fast path produced the token
    alpha: torch.Tensor       # (B,) f32  — hot-vocab mass (Eq. 7)
    exact_fast: torch.Tensor  # (B,) bool — containment guard passed


def shvs_masses(z: torch.Tensor, hot: HotSet):
    """The single streaming pass over V (Eq. 6–7): returns
    (m, S_hot, S_tail, tail_max), each (B,).

    A CUDA tensor goes through the ``shvs_masses`` kernel. On the CPU
    S_tail is ``S_tot − S_hot``, exactly as the reference's live path
    computes it, so sampled streams match the reference engine's.
    """
    if z.is_cuda:
        from repro_torch.kernels import ops
        return ops.fused_shvs_masses(z, hot.mask)
    m = z.amax(-1)
    w = torch.exp(z - m[:, None])
    hotf = hot.mask.to(z.dtype)[None, :]
    s_hot = (w * hotf).sum(-1)
    s_tot = w.sum(-1)
    s_tail = s_tot - s_hot
    tail_max = torch.where(hot.mask[None, :], NEG_INF, z).amax(-1)
    return m, s_hot, s_tail, tail_max


def shvs_sample(z: torch.Tensor, params: SamplingParams, hot: HotSet,
                u_accept: torch.Tensor, u_hot: torch.Tensor,
                u_tail: torch.Tensor, *, k_cap: int = 1024) -> SHVSResult:
    """SHVS on penalized logits z (B, V).

    * no filters (top_k=0, top_p=1, min_p=0): the paper's exact rejection
      sampler — accept the hot draw iff u ≤ α, else draw from the tail.
    * filters on: truncation-first on the H hot columns, exact iff the
      filter support is provably contained in H and the truncation is
      exact; other rows fall back to the full-V truncation-first path.
    """
    B, V = z.shape
    zs = temperature_scale(z, params.temperature)
    m, s_hot, s_tail, tail_max = shvs_masses(zs, hot)
    alpha = s_hot / torch.clamp(s_hot + s_tail, min=1e-30)

    hot_z = zs[:, hot.indices]                            # (B, H) gather
    H = hot.indices.shape[0]
    kc = min(k_cap, H)
    s_tot = s_hot + s_tail

    # ---- filtered fast path: truncation-first on the hot block -----------
    trunc = truncation_first_sample(hot_z, params, u_hot, k_cap=kc,
                                    z_is_scaled=True, full_total=s_tot,
                                    full_max=m)
    fast_tokens = hot.indices[trunc.tokens.long()]       # map back to V
    has_filter = (params.top_k > 0) | (params.top_p < 1.0) | \
        (params.min_p > 0.0)

    # containment guards from the same streaming pass's tail_max
    hot_sorted = top_k_stable(hot_z, kc)[0]               # (B, kc) desc
    # (a) explicit top-k: the k-th best hot logit strictly beats every tail
    kk = torch.where(params.top_k > 0, torch.clamp(params.top_k, max=kc), kc)
    kth = hot_sorted.gather(1, (kk.long() - 1)[:, None])[:, 0]
    topk_contained = (params.top_k > 0) & (kth > tail_max)
    # (b) nucleus-only: the first hot prefix reaching mass top_p (under the
    # FULL normalizer) must consist of logits strictly above tail_max
    w_hot_top = torch.exp(hot_sorted - m[:, None])
    cum_full = torch.cumsum(w_hot_top, -1) / \
        torch.clamp(s_tot, min=1e-30)[:, None]
    reach = cum_full >= (torch.clamp(params.top_p, max=1.0) - 1e-7)[:, None]
    jstar = reach.to(torch.uint8).argmax(-1)              # first True (or 0)
    at_jstar = hot_sorted.gather(1, jstar[:, None])[:, 0]
    nucleus_contained = reach.any(-1) & (at_jstar > tail_max)
    # (c) min-p-only: every tail token must fail the min-p threshold
    minp_contained = (torch.exp(tail_max - m) < params.min_p) & \
        (hot_sorted[:, 0] >= m - 1e-6)
    guard = torch.where(params.top_k > 0, topk_contained,
                        torch.where(params.top_p < 1.0, nucleus_contained,
                                    minp_contained))
    exact_fast = torch.where(has_filter, guard & trunc.exact, True)

    # ---- unfiltered exact rejection path (the paper's Eq. 8–9) -----------
    w_hot = torch.exp(hot_z - m[:, None])
    hot_draw = hot.indices[_inverse_cdf_draw(w_hot, u_hot)]
    accept = u_accept <= alpha
    w_tail = torch.exp(zs - m[:, None]) * (~hot.mask[None, :])
    tail_draw = _inverse_cdf_draw(w_tail, u_tail)
    nofilter_tokens = torch.where(accept, hot_draw, tail_draw)

    tokens = torch.where(has_filter, fast_tokens, nofilter_tokens)
    accepted = torch.where(has_filter, exact_fast, accept)

    # rows whose fast path is not provably exact re-sample on full V
    full = truncation_first_sample(zs, params, u_tail, k_cap=k_cap,
                                   z_is_scaled=True)
    tokens = torch.where(has_filter & ~exact_fast, full.tokens.long(),
                         tokens)

    greedy = zs.argmax(-1)
    tokens = torch.where(params.temperature <= 0.0, greedy, tokens)
    return SHVSResult(tokens=tokens.to(torch.int32), accepted=accepted,
                      alpha=alpha, exact_fast=exact_fast)


@register_backend("shvs")
class SHVSBackend(SamplerBackend):
    """S2 + S3 — the full SIMPLE decision plane as a sampler backend.

    ``hot_set`` defaults to a contiguous low-id set sized by the SHVS config
    (tokenizers assign low ids to frequent tokens).
    """

    name = "shvs"

    def __init__(self, *, vocab_size: int, k_cap: int = 1024, shvs=None,
                 hot_set: Optional[HotSet] = None, device="cpu", **_):
        if hot_set is None:
            from repro_torch.config import SHVSConfig
            cfg = shvs if shvs is not None else SHVSConfig()
            H = cfg.resolve_hot_size(vocab_size)
            hot_set = make_hot_set(torch.arange(H), vocab_size, device)
        self.hot_set = hot_set
        self.k_cap = k_cap

    def step(self, z, params, uniforms, *, step_idx):
        res = shvs_sample(z, params, self.hot_set, uniforms[:, 0],
                          uniforms[:, 1], uniforms[:, 2], k_cap=self.k_cap)
        stats = DecisionStats(res.accepted.float().mean(), res.alpha.mean(),
                              (~res.exact_fast).float().mean())
        return res.tokens, stats
