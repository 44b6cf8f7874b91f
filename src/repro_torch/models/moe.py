"""Mixture-of-Experts FFN, the reference's local (single-device) path.

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
(``_aux_loss``) comes with the output. The expert-parallel paths of the
reference (``shard_map``) are not ported (ROADMAP 'Modules to port' item
5).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
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
    x_flat = x.reshape(B * S, d)
    ids, gates, probs = _route(params["router"], x_flat, m.num_experts,
                               m.top_k)
    cap = _capacity(B * S, m.top_k, m.num_experts, m.capacity_factor)
    out = _dispatch_compute_combine(
        x_flat, ids, gates, params["w_gate"], params["w_up"],
        params["w_down"], m.num_experts, cap, cfg.act).reshape(B, S, d)
    if "shared" in params:
        out = out + apply_mlp(params["shared"], x, cfg.act)
    if not train:
        return out, 0.0
    return out, _aux_loss(probs, ids, m.num_experts) * m.aux_loss_weight
