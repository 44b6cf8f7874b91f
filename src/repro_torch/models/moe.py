"""Mixture-of-Experts FFN with expert parallelism.

Two execution paths with identical semantics, as in the reference:

* **local** (no mesh): capacity-bucketed dispatch on one device.
* **expert-parallel** (a mesh, ``models/dist.py``): each rank holds only
  its expert block — E over the model axes, the expert hidden dim f over
  the batch axes (``launch/sharding.param_spec``) — and its batch block
  of tokens. It routes the tokens, computes only its local experts'
  contribution, and the partial outputs are combined with one ``psum``
  over the model axes (``_apply_moe_ep``: the f-slices gathered first,
  weights-stationary), or tokens are gathered over the batch axes, each
  rank computes its f-slice and the partials go back by ``psum_scatter``
  and ``psum`` (``_apply_moe_ep_scatter``: activations-moving).
  ``_prefer_scatter``'s traffic model picks (``REPRO_MOE_STRATEGY``
  overrides it, as in the reference).

Capacity-bucketed dispatch: every (token, k) pair is routed to one
expert's bucket of ``C = max(8, min(T·k, ⌈T·k/E · capacity_factor⌉))``
slots, over all T = B·S tokens of the call (empty decode slots, pad
positions and rows outside a chunk's mask included, as in the
reference). A pair's slot is its rank among earlier pairs of the same
expert in flattened ``t·k + j`` order; pairs past C are dropped (combine
weight 0), the standard Switch/GShard behaviour.

Shapes stay fixed and nothing reads back to the host: the buckets are an
``(E, C + 1, d)`` buffer whose last row takes every dropped pair and is
cut off before the experts run, so no index is out of bounds and no
step synchronises the stream. In training the load-balance loss
(``_aux_loss``) comes with the output; on the expert-parallel paths it is
the mean of the data blocks' losses (``pmean``), as in the reference.

The reference's shape arithmetic reads the global batch; a rank's ``x``
is its block, so the EP paths take B = b_loc · dp (the batch is split
evenly over the batch axes under a mesh).
"""
from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models import dist
from repro_torch.models.layers import (apply_mlp, dense_init, init_mlp,
                                      matmul, torch_dtype)


def init_moe(gen: torch.Generator, cfg: ModelConfig, device, stacked: int = 0):
    """Seeded MoE weights in the reference's layout: the router in f32,
    experts ``(E, in, out)``, the optional always-on shared expert."""
    m = cfg.moe
    assert m is not None
    d, E, fe = cfg.d_model, m.num_experts, m.d_ff_expert
    dt = torch_dtype(cfg.dtype)
    pre = (stacked,) if stacked else ()
    p = {"router": dense_init(gen, pre + (d, E), torch.float32, device),
         "w_gate": dense_init(gen, pre + (E, d, fe), dt, device),
         "w_up": dense_init(gen, pre + (E, d, fe), dt, device),
         "w_down": dense_init(gen, pre + (E, fe, d), dt, device)}
    if m.shared_expert_d_ff:
        p["shared"] = init_mlp(gen, cfg, device, d_ff=m.shared_expert_d_ff,
                               stacked=stacked)
    return p


def _route(router_w, x_flat, num_experts: int, top_k: int):
    """Router: returns (ids (T, k) int64, gates (T, k) f32, probs (T, E)
    f32). Equal probabilities rank the lower expert first, as
    ``jax.lax.top_k`` does: a stable descending sort keeps index order."""
    logits = torch.matmul(x_flat.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = vals[:, :top_k], idx[:, :top_k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return ids, gates, probs


def _aux_loss(probs, ids, num_experts: int):
    """Switch-style load-balance loss: E * sum_e f_e * P_e. The one-hot
    is a comparison, so no class check reads the ids back."""
    experts = torch.arange(num_experts, device=ids.device)
    assign = (ids[:, :1] == experts[None]).float()
    f = assign.mean(0)                       # fraction routed (top-1 proxy)
    pbar = probs.mean(0)
    return num_experts * torch.sum(f * pbar)


def _expert_compute(x_buf, w_gate, w_up, w_down, act: str):
    """Batched per-expert MLP: x_buf (E, C, d) -> (E, C, d). Each product
    accumulates in f32 and rounds to the activation dtype."""
    if act == "silu":
        g = matmul(x_buf, w_gate)
        u = matmul(x_buf, w_up)
        h = F.silu(g.float()).to(x_buf.dtype) * u
    else:
        h = F.gelu(torch.matmul(x_buf.float(), w_up.float()),
                   approximate="tanh").to(x_buf.dtype)
    return matmul(h, w_down)


def _slots(ids_flat, num_experts: int, capacity: int):
    """Bucket slots of the flattened (token, k) pairs: returns (expert
    (T·k,) with invalid ids on expert 0, slot (T·k,) with every dropped or
    invalid pair on the overflow row ``capacity``, keep (T·k,) bool).
    A pair's slot is its rank among earlier pairs of the same expert (the
    one-hot's cumsum minus itself); the one-hot is a comparison, so no
    class check reads the ids back."""
    valid = ids_flat >= 0
    safe_ids = torch.where(valid, ids_flat, 0).long()
    experts = torch.arange(num_experts, device=ids_flat.device)
    oh = ((safe_ids[:, None] == experts[None]) & valid[:, None]).long()
    pos = (oh.cumsum(0) - oh).gather(1, safe_ids[:, None])[:, 0]
    keep = valid & (pos < capacity)
    return safe_ids, torch.where(keep, pos, capacity), keep


def _dispatch_compute_combine(x_flat, ids, gates, w_gate, w_up, w_down,
                              num_experts: int, capacity: int, act: str):
    """Capacity-bucket dispatch -> per-expert MLP -> weighted combine.

    x_flat: (T, d); ids/gates: (T, k). ids < 0 mean "invalid" and are
    dropped, as in the reference."""
    T, k = ids.shape
    d = x_flat.shape[-1]
    gates_flat = gates.reshape(T * k)
    safe_ids, slot, keep = _slots(ids.reshape(T * k), num_experts, capacity)
    x_rep = x_flat[:, None].expand(T, k, d).reshape(T * k, d)
    # out of place, so autograd sees the scatter: the overflow row C takes
    # every dropped pair and is cut off, so their gradient is 0, as with
    # the reference's mode="drop"
    buf = x_flat.new_zeros((num_experts, capacity + 1, d)).index_put(
        (safe_ids, slot), x_rep)
    out_buf = _expert_compute(buf[:, :capacity], w_gate, w_up, w_down, act)
    # gather back (the zero row C for dropped pairs) + weighted combine
    y = F.pad(out_buf, (0, 0, 0, 1))[safe_ids, slot]
    y = y * (gates_flat * keep).to(y.dtype)[:, None]
    return y.reshape(T, k, d).sum(dim=1)


def _capacity(tokens: int, k: int, num_experts: int, factor: float) -> int:
    c = int(math.ceil(tokens * k / num_experts * factor))
    return max(8, min(tokens * k, c))


def apply_moe(params, x, cfg: ModelConfig, *, train: bool = False):
    """MoE FFN. x: (B, S, d). Returns (out (B, S, d), aux): the
    load-balance loss weighed by ``aux_loss_weight`` in training; outside
    training the reference weighs it by 0, and here it is the number 0,
    not computed."""
    m = cfg.moe
    B, S, d = x.shape
    ctx = dist.get_ctx()
    ep = ctx.axis_size(ctx.model_axes)
    if ctx.active and ep > 1 and m.num_experts % ep == 0:
        path = _apply_moe_ep_scatter if _prefer_scatter(x, cfg, ctx) \
            else _apply_moe_ep
        out, aux = path(params, x, cfg, ep, train)
    else:
        # the local dispatch runs over the global batch, as the
        # reference's does: a rank holding a data block gathers the others
        b_axes = ctx.batch_axes if ctx.active else None
        x_all = dist.all_gather(x, b_axes, dim=0, tiled=True)
        T = x_all.shape[0] * S
        x_flat = x_all.reshape(T, d)
        ids, gates, probs = _route(params["router"], x_flat, m.num_experts,
                                   m.top_k)
        cap = _capacity(T, m.top_k, m.num_experts, m.capacity_factor)
        w_gate, w_up, w_down = _whole_f(params, cfg, ctx)
        out = _dispatch_compute_combine(
            x_flat, ids, gates, w_gate, w_up, w_down, m.num_experts, cap,
            cfg.act).reshape(x_all.shape)
        if out.shape[0] != B:
            r0, _ = dist.rows(out.shape[0], b_axes)
            out = out[r0:r0 + B]
        aux = _aux_loss(probs, ids, m.num_experts) if train else None
    if "shared" in params:
        out = out + apply_mlp(params["shared"], x, cfg.act)
    if not train:
        return out, 0.0
    return out, aux * m.aux_loss_weight


def _whole_f(params, cfg: ModelConfig, ctx):
    """The expert weights with the whole hidden dim f: a rank holding an
    FSDP f-slice (``param_spec`` splits f over the batch axes) gathers the
    others' (the weights-stationary pattern, ZeRO-3)."""
    ws = params["w_gate"], params["w_up"], params["w_down"]
    if ws[0].shape[-1] == cfg.moe.d_ff_expert:
        return ws
    ax = _fsdp_axis(ctx)
    return (dist.all_gather(ws[0], ax, dim=ws[0].dim() - 1, tiled=True),
            dist.all_gather(ws[1], ax, dim=ws[1].dim() - 1, tiled=True),
            dist.all_gather(ws[2], ax, dim=ws[2].dim() - 2, tiled=True))


def _global_batch(x, ctx) -> int:
    """The global batch of a rank's block: b_loc · dp."""
    return x.shape[0] * ctx.axis_size(ctx.batch_axes)


def _fsdp_axis(ctx):
    """The FSDP storage axes for expert weights (all batch axes)."""
    baxes = tuple(ctx.batch_axes or ())
    return baxes or None


def _fsdp_size(ctx) -> int:
    return ctx.axis_size(_fsdp_axis(ctx))


def _prefer_scatter(x, cfg: ModelConfig, ctx) -> bool:
    """Traffic model: activations-moving wins when 2·tokens·d·bytes is less
    than the per-rank FSDP expert-weight gather. REPRO_MOE_STRATEGY
    ∈ {auto, gather, scatter} overrides (the reference's ablation knob).
    Tokens are the global batch's (the rank's block · dp)."""
    force = os.environ.get("REPRO_MOE_STRATEGY", "auto")
    ax = _fsdp_axis(ctx)
    if force == "gather" or ax is None:
        return False
    fsdp = _fsdp_size(ctx)
    if force == "scatter":
        return fsdp > 1 and cfg.moe.d_ff_expert % fsdp == 0
    if fsdp <= 1 or cfg.moe.d_ff_expert % fsdp != 0:
        return False
    _, S, d = x.shape
    B = _global_batch(x, ctx)
    itemsize = x.element_size()
    tokens_traffic = 2 * B * S * d * itemsize
    e_loc = cfg.moe.num_experts // max(ctx.axis_size(ctx.model_axes), 1)
    weight_traffic = (3 * e_loc * d * cfg.moe.d_ff_expert * itemsize
                      * (fsdp - 1) // fsdp)
    return tokens_traffic < weight_traffic


def _local_ids(ids, ctx, e_local: int):
    """Global expert ids -> this rank's local ids; foreign experts -> -1
    (dropped here, computed by the rank that owns them)."""
    offset = dist.axis_index(ctx.model_axes) * e_local
    local = ids - offset
    return torch.where((local >= 0) & (local < e_local), local, -1)


def _apply_moe_ep_scatter(params, x, cfg: ModelConfig, ep: int,
                          train: bool):
    """Activations-moving expert parallelism (decode-optimized).

    Tokens are all-gathered over the FSDP axes; every (fsdp, model) rank
    computes its local experts' contribution using only its LOCAL f-slice
    of the expert weights (never gathering them); partial outputs are
    reduce-scattered back over the FSDP axes and psum'd over model.
    """
    m = cfg.moe
    ctx = dist.get_ctx()
    _, S, d = x.shape
    e_local = m.num_experts // ep
    fsdp_ax = _fsdp_axis(ctx)
    baxes = tuple(ctx.batch_axes or ())
    # tokens a rank holds after gathering over every fsdp axis: the batch
    T_gathered = _global_batch(x, ctx) * S
    cap = _capacity(T_gathered, m.top_k, m.num_experts, m.capacity_factor)
    x_all = dist.all_gather(x, fsdp_ax, dim=0, tiled=True)
    b = x_all.shape[0]
    x_flat = x_all.reshape(b * S, d)
    ids, gates, probs = _route(params["router"], x_flat, m.num_experts,
                               m.top_k)
    y = _dispatch_compute_combine(
        x_flat, _local_ids(ids, ctx, e_local), gates, params["w_gate"],
        params["w_up"], params["w_down"], e_local, cap, cfg.act)
    y = y.reshape(b, S, d)
    # sum the f-slice partials + return each token to its home rank
    y = dist.psum_scatter(y, fsdp_ax, dim=0)
    y = dist.psum(y, ctx.model_axes)          # combine expert partials
    aux = None
    if train:
        aux = _aux_loss(probs, ids, m.num_experts)
        if baxes[:-1]:
            aux = dist.pmean(aux, baxes[:-1])
    return y, aux


def _apply_moe_ep(params, x, cfg: ModelConfig, ep: int, train: bool):
    """Expert-parallel path: the rank's tokens, its experts (their f
    gathered over the FSDP axes), one psum over the model axes."""
    m = cfg.moe
    ctx = dist.get_ctx()
    b, S, d = x.shape
    e_local = m.num_experts // ep
    # tokens a rank (the global batch over the batch axes)
    T_local = (_global_batch(x, ctx) // ctx.axis_size(ctx.batch_axes)) * S
    cap = _capacity(T_local, m.top_k, m.num_experts, m.capacity_factor)
    w_gate, w_up, w_down = _whole_f(params, cfg, ctx)
    x_flat = x.reshape(b * S, d)
    ids, gates, probs = _route(params["router"], x_flat, m.num_experts,
                               m.top_k)
    y = _dispatch_compute_combine(
        x_flat, _local_ids(ids, ctx, e_local), gates, w_gate, w_up, w_down,
        e_local, cap, cfg.act)
    y = dist.psum(y, ctx.model_axes)          # combine expert partials
    aux = None
    if train:
        aux = _aux_loss(probs, ids, m.num_experts)
        if ctx.batch_axes:
            aux = dist.pmean(aux, tuple(ctx.batch_axes))
    return y.reshape(b, S, d), aux
