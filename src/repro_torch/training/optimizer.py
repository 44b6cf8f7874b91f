"""AdamW + LR schedule + global-norm clipping, the reference's formulas
as plain functions over nested dicts of tensors (not ``torch.optim``).

State and math follow Loshchilov & Hutter (decoupled weight decay):
moments are float32 whatever the parameter's dtype, the update is
computed in float32 and cast back to the parameter's dtype, decay applies
to matrices only (``ndim >= 2``), and the bias correction uses the step as
a float32. Leaves are visited in sorted key order, as ``jax.tree_util``
flattens a dict, so sums over the tree add in the reference's order.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.config import TrainConfig


def tree_leaves(tree) -> list:
    """The leaves of a nested dict, in sorted key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same keys); keys visited in sorted order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_unflatten(like, leaves):
    """A tree shaped as ``like`` holding ``leaves`` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


class AdamWState(NamedTuple):
    step: torch.Tensor   # () int32
    mu: dict             # first moments (f32)
    nu: dict             # second moments (f32)


def adamw_init(params) -> AdamWState:
    f32 = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device)
    dev = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_map(f32, params), nu=tree_map(f32, params))


def lr_schedule(cfg: TrainConfig, step):
    """Linear warmup then cosine decay to 10%; ``step`` a tensor."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) /
                    max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.1 + 0.9 * 0.5 * (1.0 + torch.cos(math.pi * t))
    return cfg.learning_rate * warm * cos


def global_norm(tree, split_axes=None) -> torch.Tensor:
    """The L2 norm of every leaf of ``tree``. Under a mesh,
    ``split_axes`` gives per leaf (in :func:`tree_leaves` order) the mesh
    axes it is split over: a leaf's squares are summed over the ranks of
    those axes (one ``psum`` per set of axes, the leaves' sums packed), so
    a split leaf adds every block and a whole one counts once, and the
    norm is the same on every rank."""
    sq = [torch.sum(torch.square(leaf.float())) for leaf in tree_leaves(tree)]
    if split_axes is not None:
        from repro_torch.models import dist
        by_axes = {}
        for i, axes in enumerate(split_axes):
            if axes:
                by_axes.setdefault(tuple(axes), []).append(i)
        with dist.phase("norm"):
            for axes, idx in by_axes.items():
                summed = dist.psum(torch.stack([sq[i] for i in idx]), axes)
                for i, v in zip(idx, summed.unbind(0)):
                    sq[i] = v
    return torch.sqrt(sum(sq))


def clip_by_global_norm(grads, max_norm: float, split_axes=None):
    norm = global_norm(grads, split_axes)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, cfg: TrainConfig,
                 split_axes=None):
    """One AdamW step. Returns (params, state, metrics); the new
    parameters are new tensors (the old ones are not written). Under a
    mesh the leaves are the rank's blocks, ``split_axes`` as
    :func:`global_norm` takes them; the update is elementwise, so each
    rank steps its own blocks."""
    grads = tree_map(lambda g: g.float(), grads)
    if cfg.grad_clip > 0:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, split_axes)
    else:
        gnorm = global_norm(grads, split_axes)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()

    def upd(p, g, m, v):
        m2 = b1 * m + (1 - b1) * g
        v2 = b2 * v + (1 - b2) * torch.square(g)
        mhat = m2 / bc1
        vhat = v2 / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        # decoupled weight decay on matrices only (ndim >= 2)
        if p.dim() >= 2:
            delta = delta + cfg.weight_decay * p.float()
        p2 = p.float() - lr * delta
        return p2.to(p.dtype), m2, v2

    out = tree_map(upd, params, grads, state.mu, state.nu)
    metrics = {"lr": lr, "grad_norm": gnorm}
    return _pick(out, 0), AdamWState(step=step, mu=_pick(out, 1),
                                     nu=_pick(out, 2)), metrics


def _pick(tree, i):
    """Element ``i`` of every tuple leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]
