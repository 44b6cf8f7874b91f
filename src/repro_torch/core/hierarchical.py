"""Hierarchical (block-local) decision plane — beyond-paper optimization.

The paper's S1 moves the (B, V) logits so each sampler owns whole rows.
This mode leaves the logits WHERE THE LM HEAD PRODUCED THEM — each rank
its (B/dp, V/t) block — and makes the decision hierarchically with
block-local O(V/t) passes plus collectives of only per-row *statistics*:

  masses           : max and sums of (B_loc,) scalars          (Eq. 6–7)
  top-k candidates : all-gather of (B_loc, k) local top-k       (exact merge)
  categorical draw : two-level inverse-CDF — pick the block by its mass
                     prefix, then draw inside it                (exact)

Collective volume drops from O(B·V/t) (S1's all-to-all) or O(B·V) (the
baseline's all-gather) to O(B·(k + t)), while every result is
bit-compatible with the single-device decision plane (same uniforms, same
vocab-order CDFs, modulo float associativity).

Penalty state lives with the logits blocks (B@batch, V@model): the Eq. 5
update touches only the block owning the sampled token.

The reference runs this as one ``shard_map``; here each rank runs the
body on its block. Its collectives are packed: one ``pmax`` of the row
maxima, one ``all_gather`` of the local top-k, masses and greedy
candidate, and one ``psum`` of the two draws. The penalty pass is
``ops.fused_penalty_scale`` with the rows' τ: the ``penalty_scale`` kernel
on a CUDA block, its plain version on the CPU (bit-equal:
``apply_penalties_rows`` then ``/ max(τ, 1e-6)``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import penalties as pen
from repro_torch.core.sampling import SamplingParams, top_k_stable
from repro_torch.core.shvs import HotSet
from repro_torch.kernels import ops
from repro_torch.models import dist

NEG_INF = -1e30


class HierResult(NamedTuple):
    tokens: torch.Tensor
    accepted: torch.Tensor
    alpha: torch.Tensor
    exact_fast: torch.Tensor


def block_geometry(V_real: int):
    """(V padded to a multiple of t, V/t a block, this rank's column
    offset) on the context's model axes."""
    ctx = dist.get_ctx()
    tp = ctx.axis_size(ctx.model_axes)
    V = -(-V_real // tp) * tp
    V_loc = V // tp
    return V, V_loc, dist.axis_index(ctx.model_axes) * V_loc


def block_hot_columns(hot: HotSet, V_real: int) -> torch.Tensor:
    """The rank's hot columns within its block, ascending (vocab order).
    ``nonzero`` reads back to the host, so callers keep the result for as
    long as the hot set and the mesh stay (``DecisionPlane`` does)."""
    V, V_loc, v_off = block_geometry(V_real)
    hot_loc = F.pad(hot.mask, (0, V - V_real))[v_off:v_off + V_loc]
    return torch.nonzero(hot_loc).flatten()


def _local_draw_target(cdf, target, prefix):
    """Index of the first element whose inclusive local cumsum ``cdf``
    exceeds (target - prefix); clipped to the local width."""
    t = (target - prefix)[:, None]
    idx = (cdf <= t).sum(-1)
    return torch.clamp(idx, max=cdf.shape[-1] - 1)


def hierarchical_sample(logits: torch.Tensor, state: pen.PenaltyState,
                        params: SamplingParams, uniforms: torch.Tensor,
                        hot: HotSet, *, k_cap: int = 1024, vocab: int,
                        hot_cols=None):
    """Full decision step on the rank's block of the logits.

    logits: (B_loc, V/t) where t divides V, else (B_loc, V) whole rows
    (the LM head's block); ``state`` in the same layout; ``params`` and
    ``uniforms`` ((B_loc, 3): accept, hot/main, tail) the rank's rows;
    ``hot`` the global hot set; ``vocab`` the global V; ``hot_cols`` the
    rank's :func:`block_hot_columns` (found here when not given). Returns
    (tokens (B_loc,) equal on every model rank, new state, HierResult
    stats).
    """
    ctx = dist.get_ctx()
    assert ctx.active, "hierarchical mode requires a mesh"
    if hot is None:
        raise ValueError("hierarchical mode needs a hot set (algorithm "
                         "'shvs' or 'fused' supplies one)")
    m_axes = tuple(ctx.model_axes or ())
    tp = ctx.axis_size(m_axes)
    r = dist.axis_index(m_axes)
    V_real = vocab
    # pad the vocab axis to a multiple of tp (NEG_INF logits / zero counts
    # / tail membership: padded ids are never selected)
    V, V_loc, v_off = block_geometry(V_real)
    blocked = logits.shape[1] == V_loc and V == V_real and tp > 1
    if blocked:
        z_loc, cp_loc, co_loc = logits, state.prompt_counts, \
            state.output_counts
    else:
        if logits.shape[1] != V_real:
            raise ValueError(f"logits block {tuple(logits.shape)} is "
                             f"neither V = {V_real} nor V/t")
        pad = V - V_real

        def block(x, value):
            return F.pad(x, (0, pad), value=value)[:, v_off:v_off + V_loc]

        z_loc = block(logits, NEG_INF)
        cp_loc = block(state.prompt_counts, 0)
        co_loc = block(state.output_counts, 0)
    hot_loc = F.pad(hot.mask, (0, V - V_real))[v_off:v_off + V_loc]
    kc = min(k_cap, V_loc)
    Bl = z_loc.shape[0]

    # ---- penalties + temperature, block-local -----------------------------
    z = ops.fused_penalty_scale(
        z_loc.contiguous(), cp_loc.contiguous(), co_loc.contiguous(),
        params.repetition_penalty, params.presence_penalty,
        params.frequency_penalty, params.temperature)
    hot_f = hot_loc.float()[None, :]
    if hot_cols is None:
        hot_cols = block_hot_columns(hot, V_real)

    # ---- Eq. 6–7 masses: local reductions + tiny collectives -------------
    # A block's masses are the last entries of its inclusive CDFs: over
    # its hot columns (in vocab order) and over the rest. The draws below
    # walk the same CDFs, so a block's share of the mass and its local
    # draw agree to the bit (on one block, as the single-device plane's)
    m_loc = z.amax(-1)
    m_glob = dist.pmax(m_loc, m_axes)
    w = torch.exp(z - m_glob[:, None])
    cdf_hot = torch.cumsum(w[:, hot_cols], dim=-1)         # (Bl, H_loc)
    cdf_tail = torch.cumsum(w * (1.0 - hot_f), dim=-1)     # (Bl, V_loc)
    s_hot_loc = cdf_hot[:, -1] if hot_cols.numel() else w.new_zeros(Bl)
    s_tail_loc = cdf_tail[:, -1]

    # ---- one all-gather: local top-k, masses and greedy candidate --------
    vals_loc, idx_loc = top_k_stable(z, kc)
    g_idx = (z.argmax(-1) + v_off).float()       # exact: V < 2^24
    packed = torch.cat([
        vals_loc, (idx_loc + v_off).to(torch.int32).view(torch.float32),
        torch.stack([s_hot_loc, s_tail_loc, m_loc, g_idx], dim=1)], dim=1)
    allg = dist.all_gather(packed, m_axes, dim=0)          # (tp, Bl, 2kc+4)
    vals_cat = allg[:, :, :kc].permute(1, 0, 2).reshape(Bl, tp * kc)
    idx_cat = allg[:, :, kc:2 * kc].contiguous().view(torch.int32) \
        .permute(1, 0, 2).reshape(Bl, tp * kc).long()
    s_hot_all = allg[:, :, 2 * kc].T                       # (Bl, tp)
    s_tail_all = allg[:, :, 2 * kc + 1].T
    s_hot = s_hot_all.sum(-1)
    s_tail = s_tail_all.sum(-1)
    s_tot = s_hot + s_tail
    alpha = s_hot / torch.clamp(s_tot, min=1e-30)
    k_eff = min(k_cap, tp * kc)
    top_vals, top_pos = top_k_stable(vals_cat, k_eff)      # (Bl, k)
    top_idx = idx_cat.gather(1, top_pos)

    # ---- filtered fast path on the candidate set ---------------------------
    sp = params
    pos = torch.arange(k_eff, device=z.device)[None, :]
    kk = torch.where(sp.top_k > 0, torch.clamp(sp.top_k, max=k_eff), k_eff)
    keep = pos < kk[:, None]
    wc = torch.exp(top_vals - m_glob[:, None])
    subset_total = (wc * keep).sum(-1)
    norm_total = torch.where(sp.top_k > 0, subset_total, s_tot)
    p = wc * keep / torch.clamp(norm_total[:, None], min=1e-30)
    cum = torch.cumsum(p, dim=-1)
    keep = keep & ((cum - p) < sp.top_p[:, None])
    keep = keep & (p >= sp.min_p[:, None] * p[:, :1])
    pf = torch.where(keep, p, 0.0)
    cdf_f = torch.cumsum(pf, dim=-1)
    tgt_f = uniforms[:, 1] * cdf_f[:, -1]
    j = torch.clamp((cdf_f <= tgt_f[:, None]).sum(-1), max=k_eff - 1)
    fast_tokens = top_idx.gather(1, j[:, None])[:, 0]
    has_filter = (sp.top_k > 0) | (sp.top_p < 1.0) | (sp.min_p > 0.0)
    # guards: the candidate set (the merged global top-k_eff of the FULL
    # distribution) must contain the filter support
    mass_at_cap = (wc * (pos < kk[:, None])).sum(-1) / \
        torch.clamp(norm_total, min=1e-30)
    explicit_k = (sp.top_k > 0) & (sp.top_k <= k_eff)
    nucleus_ok = (sp.top_p < 1.0) & (mass_at_cap >= sp.top_p - 1e-7)
    p_last = wc[:, -1] / torch.clamp(norm_total, min=1e-30)
    minp_ok = (sp.min_p > 0.0) & (p_last < sp.min_p * p[:, 0])
    full_ok = mass_at_cap >= 1.0 - 1e-7
    exact_fast = explicit_k | nucleus_ok | minp_ok | full_ok

    # ---- unfiltered exact path: two-level draw (SHVS Eq. 8–9) -------------
    def claim(cdf, cols, s_all, s_part_loc, u_col):
        """Pick the block by its mass prefix, then draw inside it: the
        global column where this block owns the draw, else 0."""
        cdf_sh = torch.cumsum(s_all, dim=-1)
        total = cdf_sh[:, -1]
        target = u_col * total
        pre = (cdf_sh - s_all)[:, r]       # exclusive prefix of OWN block
        mine = (target >= pre) & (target < pre + s_part_loc + 1e-30)
        if cdf.shape[-1] == 0:                 # no column of this part here
            return torch.zeros_like(target, dtype=torch.int64)
        idx = _local_draw_target(cdf, target, pre)
        col = idx if cols is None else cols[idx]
        return torch.where(mine, col + v_off, 0)

    hot_draw, tail_draw = dist.psum(torch.stack([
        claim(cdf_hot, hot_cols, s_hot_all, s_hot_loc, uniforms[:, 1]),
        claim(cdf_tail, None, s_tail_all, s_tail_loc, uniforms[:, 2])]),
        m_axes)
    accept = uniforms[:, 0] <= alpha
    nofilter_tokens = torch.where(accept, hot_draw, tail_draw)

    tokens = torch.where(has_filter, fast_tokens, nofilter_tokens)
    gbest = allg[:, :, 2 * kc + 2].argmax(0)                # (Bl,)
    greedy = allg[:, :, 2 * kc + 3].T.gather(1, gbest[:, None])[:, 0]
    tokens = torch.where(sp.temperature <= 0.0, greedy.long(), tokens)
    accepted = torch.where(has_filter, exact_fast, accept)

    # ---- Eq. 5 incremental update ------------------------------------------
    if blocked:
        tok_loc = tokens - v_off
        in_range = (tok_loc >= 0) & (tok_loc < V_loc)
        co2 = co_loc.clone()
        co2.scatter_add_(1, torch.where(in_range, tok_loc, 0)[:, None],
                         in_range.int()[:, None])
        new_state = pen.PenaltyState(prompt_counts=state.prompt_counts,
                                     output_counts=co2)
    else:
        # whole rows on every model rank: the tokens are equal on all of
        # them, so each updates its copy (a padded id is dropped)
        new_state = pen.update_histograms(state, tokens)
    tokens = torch.clamp(tokens, max=V_real - 1).to(torch.int32)
    return tokens, new_state, HierResult(tokens=tokens, accepted=accepted,
                                         alpha=alpha, exact_fast=exact_fast)
