"""Reference + truncation-first sampling pipelines (paper §2.1, §5.2).

Two distribution-identical implementations of the production control set
(temperature, top-k, nucleus top-p, min-p):

* :func:`sample_reference` — the oracle: full-vocabulary masked softmax.
* :func:`truncation_first_sample` — the paper's S2: truncate to the k_cap
  best logits first, normalize and draw on the truncated domain, and map
  the result back through the index map.

Both consume explicit uniforms so that determinism does not depend on how
the batch is laid out. All functions operate on penalized logits ``z``
(B, V) float32 with per-row (B,) controls. Sorts are stable and
descending, so equal logits resolve to the LOWEST vocabulary id, as
``lax.top_k`` and ``argsort(stable=True)`` do in the reference
(``torch.topk`` promises no order among equal values). A NaN goes where
the reference's sort puts it: last in :func:`filter_mask_reference`
(``jnp.argsort(-z)``), first in :func:`top_k_stable` (``lax.top_k``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.kernels.ref import argsort_desc

NEG_INF = -1e30


class SamplingParams(NamedTuple):
    """Per-row sampling controls.

    The seven core fields are (B,) device tensors that sampler backends
    consume. ``seed`` (uint32) / ``use_seed`` (bool) are host numpy RNG
    tags consumed by the decision plane's uniform draw
    (:mod:`repro_torch.core.rng`), which runs on the host;
    :meth:`strip_rng` drops them before the params reach a backend.
    """

    temperature: torch.Tensor     # f32; 0 => greedy
    top_k: torch.Tensor           # int32; 0 disables
    top_p: torch.Tensor           # f32; 1 disables
    min_p: torch.Tensor           # f32; 0 disables
    repetition_penalty: torch.Tensor
    presence_penalty: torch.Tensor
    frequency_penalty: torch.Tensor
    seed: Optional[np.ndarray] = None       # uint32; per-request RNG seed
    use_seed: Optional[np.ndarray] = None   # bool; row draws its own stream

    @staticmethod
    def broadcast(batch: int, cfg, device="cpu") -> "SamplingParams":
        """One ``SamplingConfig`` for every one of ``batch`` rows: the core
        fields as (B,) tensors on ``device``, the RNG tags as host arrays
        (``seed_u32`` and ``seeded``, the engine's normalisation)."""
        f = lambda v: torch.full((batch,), v, dtype=torch.float32,
                                 device=device)
        temperature = getattr(cfg, "effective_temperature", cfg.temperature)
        seeded = bool(getattr(cfg, "seeded", False))
        return SamplingParams(
            temperature=f(temperature),
            top_k=torch.full((batch,), cfg.top_k, dtype=torch.int32,
                             device=device),
            top_p=f(cfg.top_p),
            min_p=f(cfg.min_p),
            repetition_penalty=f(cfg.repetition_penalty),
            presence_penalty=f(cfg.presence_penalty),
            frequency_penalty=f(cfg.frequency_penalty),
            seed=np.full((batch,), getattr(cfg, "seed_u32", 0), np.uint32),
            use_seed=np.full((batch,), seeded, bool),
        )

    def strip_rng(self) -> "SamplingParams":
        """Drop the RNG-tag fields (already consumed by the uniform draw)."""
        return self._replace(seed=None, use_seed=None)


def temperature_scale(z: torch.Tensor, temperature: torch.Tensor
                      ) -> torch.Tensor:
    """Scale logits by per-row temperature; τ=0 rows pass through (greedy
    handled by the caller via argmax)."""
    return z.float() / torch.clamp(temperature, min=1e-6)[:, None]


def _inverse_cdf_draw(probs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Categorical draw via inverse CDF. probs: (B, N) (not necessarily
    normalized); u: (B,) in [0,1). Returns indices (B,) int64."""
    cdf = torch.cumsum(probs, -1)
    total = cdf[:, -1:]
    target = u[:, None] * total
    idx = (cdf <= target).sum(-1)
    return torch.clamp(idx, max=probs.shape[-1] - 1)


# ---------------------------------------------------------------------------
# Reference (full-vocabulary) pipeline — the baseline oracle
# ---------------------------------------------------------------------------


def filter_mask_reference(z: torch.Tensor, params: SamplingParams
                          ) -> torch.Tensor:
    """Boolean mask (B, V) of tokens allowed by top-k ∧ top-p ∧ min-p, by a
    full sort (the O(V log V) baseline the paper optimizes away). The
    sort is the reference's ``jnp.argsort(-z)``: a NaN ranks after -inf,
    so a top-k cuts NaNs first (:func:`argsort_desc`)."""
    B, V = z.shape
    order = argsort_desc(z)
    ranks = torch.empty_like(order).scatter_(
        1, order, torch.arange(V, device=z.device).expand(B, V))
    # top-k first (sequential filter composition, HF semantics)
    k = torch.where(params.top_k > 0, params.top_k, V)[:, None]
    mask = ranks < k
    # top-p on the top-k-renormalized distribution: keep the smallest
    # prefix of sorted probs with mass >= p (first token always kept)
    probs = torch.softmax(torch.where(mask, z, NEG_INF), -1)
    sp = probs.gather(1, order)
    cum = torch.cumsum(sp, -1)
    keep_sorted = (cum - sp) < params.top_p[:, None]   # exclusive prefix
    keep = torch.empty_like(keep_sorted).scatter_(1, order, keep_sorted)
    mask &= keep
    # min-p relative to the max of the top-k-filtered distribution
    pmax = probs.amax(-1, keepdim=True)
    mask &= probs >= params.min_p[:, None] * pmax
    return mask


def sample_reference(z: torch.Tensor, params: SamplingParams,
                     u: torch.Tensor) -> torch.Tensor:
    """Oracle sampler on penalized logits z (B, V). u: (B,) uniforms."""
    z = temperature_scale(z, params.temperature)
    mask = filter_mask_reference(z, params)
    probs = torch.softmax(torch.where(mask, z, NEG_INF), -1)
    tokens = _inverse_cdf_draw(probs, u)
    greedy = z.argmax(-1)
    return torch.where(params.temperature <= 0.0, greedy,
                       tokens).to(torch.int32)


def masked_probs_reference(z: torch.Tensor, params: SamplingParams
                           ) -> torch.Tensor:
    """The target distribution p̃ (B, V) — used by TVD/exactness tests."""
    z = temperature_scale(z, params.temperature)
    mask = filter_mask_reference(z, params)
    return torch.softmax(torch.where(mask, z, NEG_INF), -1)


# ---------------------------------------------------------------------------
# Truncation-first pipeline (paper S2)
# ---------------------------------------------------------------------------


class TruncResult(NamedTuple):
    tokens: torch.Tensor          # (B,) int32
    exact: torch.Tensor           # (B,) bool — fast path provably exact


def top_k_stable(z: torch.Tensor, k: int):
    """The k largest entries per row, descending, equal values in
    ascending index order (``lax.top_k`` semantics)."""
    vals, idx = torch.sort(z, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def truncation_first_sample(z: torch.Tensor, params: SamplingParams,
                            u: torch.Tensor, *, k_cap: int,
                            z_is_scaled: bool = False,
                            full_total: Optional[torch.Tensor] = None,
                            full_max: Optional[torch.Tensor] = None
                            ) -> TruncResult:
    """Truncation-first sampling (§5.2).

    When ``z`` is itself a subset of a larger distribution (the SHVS hot
    block), pass ``full_total = Σ_v exp(z_full − m_full)`` and ``full_max
    = m_full`` so nucleus/min-p thresholds use the TRUE normalizer; rows
    whose subset misses the global max are marked inexact.
    """
    B, V = z.shape
    k_cap = min(k_cap, V)
    z = z if z_is_scaled else temperature_scale(z, params.temperature)
    vals, idx = top_k_stable(z, k_cap)                  # (B, k) desc
    m_local = vals[:, :1]
    w = torch.exp(vals - m_local)
    pos = torch.arange(k_cap, device=z.device)[None, :]
    kk = torch.where(params.top_k > 0, torch.clamp(params.top_k, max=k_cap),
                     k_cap)
    keep = pos < kk[:, None]
    subset_total = (w * keep).sum(-1)
    if full_total is not None:
        assert full_max is not None
        has_max = full_max <= m_local[:, 0] + 1e-6
        ft_basis = full_total * torch.exp(full_max - m_local[:, 0])
        norm_total = torch.where(params.top_k > 0, subset_total, ft_basis)
    else:
        has_max = torch.ones((B,), dtype=torch.bool, device=z.device)
        ft_basis = torch.exp(z - m_local).sum(-1)      # O(V) sum, no sort
        norm_total = torch.where(params.top_k > 0, subset_total, ft_basis)
    p = w * keep / torch.clamp(norm_total[:, None], min=1e-30)
    # nucleus within the (sorted) subset; exclusive prefix mass
    cum = torch.cumsum(p, -1)
    keep &= (cum - p) < params.top_p[:, None]
    # min-p (relative to the max prob of the top-k-filtered distribution)
    keep &= p >= params.min_p[:, None] * p[:, :1]
    pf = torch.where(keep, p, 0.0)
    j = _inverse_cdf_draw(pf, u)
    tokens = idx.gather(1, j[:, None])[:, 0]
    tokens = torch.where(params.temperature <= 0.0, idx[:, 0], tokens)
    # exactness: the truncated nucleus must have reached mass top_p over
    # the TRUE filtered distribution, unless an explicit top_k <= k_cap
    mass_at_cap = (w * (pos < kk[:, None])).sum(-1) / \
        torch.clamp(norm_total, min=1e-30)
    explicit_k = (params.top_k > 0) & (params.top_k <= k_cap)
    nucleus_ok = (params.top_p < 1.0) & \
        (mass_at_cap >= torch.clamp(params.top_p, max=1.0) - 1e-7)
    # min-p: every token beyond the cap has prob <= the cap's last entry
    p_last = w[:, -1] / torch.clamp(norm_total, min=1e-30)
    minp_ok = (params.min_p > 0.0) & (p_last < params.min_p * p[:, 0])
    full_mass_ok = mass_at_cap >= 1.0 - 1e-7
    exact = (explicit_k | nucleus_ok | minp_ok | full_mass_ok) & has_max
    return TruncResult(tokens=tokens.to(torch.int32), exact=exact)
