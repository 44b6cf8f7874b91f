"""Training loop: loss, train-step factory, the Trainer.

One step is the reference's ``jax.value_and_grad`` of :func:`loss_fn`
as ``torch.autograd.grad`` over the parameter leaves, then
:func:`~repro_torch.training.optimizer.adamw_update`. The parameters a
step returns are new tensors that do not require grad, so they can be
handed to an ``Engine`` as they are.

Under a mesh (``models/dist.py``) a step is one rank's: it holds the
blocks of the leaves ``launch/sharding.param_spec`` splits (and whole
leaves where a spec leaves them so), its rows of the batch, and the V
block of the logits. The loss is the vocab-parallel cross-entropy; the
gradient is seeded with 1/n on each of the n ranks of the batch and model
axes, so that with the collectives' adjoints a rank's gradient of a leaf
is its share of the global batch's gradient, and each leaf's shares are
summed over the axes its spec does not split (:func:`grad_layout`): a
whole leaf's over every axis, a model-split leaf's over the batch axes —
the data-parallel mean. Every rank then holds its blocks of the single
process's gradient, and the clip norm adds each block once
(``optimizer.global_norm``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.device import resolve_device
from repro_torch.models import dist
from repro_torch.models.model import Model
from repro_torch.training.optimizer import (adamw_init, adamw_update,
                                            tree_leaves, tree_map,
                                            tree_unflatten)

_METRICS = ("loss", "ce", "z_loss", "moe_aux")


def _cross_entropy(logits, labels, V: int):
    """(lse, the label's logit), each (B, S). ``logits`` float32 over the
    whole vocabulary, or the rank's block of V/t columns under a mesh:
    then the row max is a ``pmax`` (no gradient: it only shifts the
    exponent), and the exp-sum and the label's logit (a masked gather, 0
    on the ranks that do not hold it) are summed by one ``psum``."""
    n = logits.shape[-1]
    if n == V:
        lse = torch.logsumexp(logits, dim=-1)
        return lse, logits.gather(-1, labels[..., None])[..., 0]
    axes = dist.get_ctx().model_axes
    m = dist.pmax(logits.detach().amax(-1), axes)
    local = labels - dist.tp_rank() * n
    mine = (local >= 0) & (local < n)
    ll = logits.gather(-1, torch.where(mine, local, 0)[..., None])[..., 0]
    parts = torch.stack([torch.exp(logits - m[..., None]).sum(-1),
                         torch.where(mine, ll, 0.0)])
    s, ll = dist.psum(parts, axes).unbind(0)
    return m + torch.log(s), ll


def loss_fn(model: Model, params, batch, cfg: TrainConfig,
            remat: bool = True):
    """Cross-entropy + z-loss + MoE aux. batch: tokens/labels (B, S), plus
    the VLM's ``patch_embeds`` or whisper's ``frames``. Under a mesh, the
    rank's rows and V block (:func:`_cross_entropy`); the loss is its
    rows', the metrics are the global batch's."""
    logits, aux = model.train_logits(params, batch, remat=remat)
    lse, ll = _cross_entropy(logits.float(), batch["labels"].long(),
                             model.cfg.vocab_size)
    ce = (lse - ll).mean()
    z_loss = cfg.z_loss_weight * torch.square(lse).mean()
    total = ce + z_loss + aux
    metrics = dict(zip(_METRICS, (total, ce, z_loss, torch.as_tensor(aux))))
    ctx = dist.get_ctx()
    if ctx.active and ctx.axis_size(ctx.batch_axes) > 1:
        with dist.phase("metrics"), torch.no_grad():
            packed = torch.stack([metrics[k].detach().float()
                                  for k in _METRICS])
            metrics = dict(zip(_METRICS, dist.pmean(packed, ctx.batch_axes)
                               .unbind(0)))
    metrics["ppl"] = torch.exp(torch.clamp(metrics["ce"], max=20.0))
    return total, metrics


def _mesh_order(axes, ctx):
    names = ctx.mesh.mesh_dim_names
    return tuple(a for a in names if a in axes)


def grad_layout(model: Model, params):
    """Per leaf of ``params`` (the rank's, in ``tree_leaves`` order): (the
    axes it is split over, the axes of the loss's ranks it is whole on),
    each in mesh order. A dimension ``param_spec`` splits counts as split
    where the leaf holds less of it than the whole leaf; the loss's ranks
    are the context's batch and model axes (those of size one left out:
    their sums are the identity)."""
    from repro_torch.launch import sharding as shd
    ctx = dist.get_ctx()
    with dist.use_mesh(None):
        whole = model.init(device="meta")
    specs = shd.param_shardings(whole, ctx.mesh, model.cfg)
    group = _mesh_order({a for a in (ctx.batch_axes or ()) +
                         (ctx.model_axes or ()) if ctx.axis_size((a,)) > 1},
                        ctx)
    out = []
    for leaf, w, spec in zip(tree_leaves(params), tree_leaves(whole),
                             tree_leaves(specs)):
        split = set()
        for i, e in enumerate(spec):
            if e is not None and leaf.shape[i] != w.shape[i]:
                split |= set(dist._axes(e))
        out.append((_mesh_order(split, ctx),
                    tuple(a for a in group if a not in split)))
    return out


def _sum_shares(grads, layout):
    """Each leaf's gradient summed over the axes it is whole on: one psum
    per set of axes, the leaves packed flat in float32."""
    by_axes = {}
    for i, (_, whole_on) in enumerate(layout):
        if whole_on:
            by_axes.setdefault(whole_on, []).append(i)
    grads = list(grads)
    for axes, idx in by_axes.items():
        flat = torch.cat([grads[i].float().reshape(-1) for i in idx])
        flat = dist.psum(flat, axes)
        for i, part in zip(idx, flat.split([grads[i].numel() for i in idx])):
            grads[i] = part.view(grads[i].shape).to(grads[i].dtype)
    return grads


def grads_of(model: Model, params, batch, cfg: TrainConfig,
             remat: bool = True, layout=None):
    """(loss, metrics, grads): ``loss_fn`` and its gradient with respect
    to every parameter leaf, a tree shaped as ``params``. Where a leaf does
    not reach the loss its gradient is zeros; under a mesh every leaf
    reaches it (as in the single process, where each family's every leaf
    does), so a leaf that does not is a severed graph and raises. Under a
    mesh the gradient is the rank's blocks of the global batch's
    (``layout``: :func:`grad_layout`, made here if not given)."""
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    leaves = tree_leaves(live)
    loss, metrics = loss_fn(model, live, batch, cfg, remat=remat)
    ctx = dist.get_ctx()
    n = ctx.axis_size(ctx.batch_axes) * ctx.axis_size(ctx.model_axes) \
        if ctx.active else 1
    seed = torch.full_like(loss, 1.0 / n)
    grads = torch.autograd.grad(loss, leaves, grad_outputs=seed,
                                allow_unused=True)
    if ctx.active:
        cut = [i for i, g in enumerate(grads) if g is None]
        if cut:
            raise RuntimeError(
                f"{len(cut)} parameter leaves get no gradient under the "
                "mesh (a collective without a backward severs the graph)")
        layout = layout or grad_layout(model, params)
        with dist.phase("dp_mean"):
            grads = _sum_shares(grads, layout)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return metrics["loss"], metrics, tree_unflatten(params, grads)


def make_train_step(model: Model, cfg: TrainConfig) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics). Under a mesh, one rank's step on its blocks (the leaves'
    layout read once, from the first step's parameters)."""
    layouts = {}

    def train_step(params, opt_state, batch):
        ctx = dist.get_ctx()
        layout = None
        if ctx.active:
            key = (id(ctx.mesh), ctx.batch_axes, ctx.model_axes)
            if key not in layouts:
                layouts[key] = grad_layout(model, params)
            layout = layouts[key]
        _, metrics, grads = grads_of(model, params, batch, cfg,
                                     remat=cfg.remat, layout=layout)
        split = [axes for axes, _ in layout] if layout else None
        params, opt_state, opt_metrics = adamw_update(
            params, grads, opt_state, cfg, split_axes=split)
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return train_step
@dataclass
class Trainer:
    """Simple single-process training loop on ``device`` (default
    ``cuda``; raises without a card), from the port's seeded init."""

    model_cfg: ModelConfig
    train_cfg: TrainConfig
    seed: int = 0
    device: str = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.model = Model(self.model_cfg)
        self.params = self.model.init(seed=self.seed, device=self.device)
        self.opt_state = adamw_init(self.params)
        self._step = make_train_step(self.model, self.train_cfg)
        self.history = []

    def fit(self, loader, steps: int, log_every: int = 10,
            log_fn: Optional[Callable] = print):
        it = iter(loader)
        t0 = time.perf_counter()
        for i in range(steps):
            batch = {k: torch.as_tensor(v, device=self.device)
                     for k, v in next(it).items()}
            self.params, self.opt_state, metrics = self._step(
                self.params, self.opt_state, batch)
            if i % log_every == 0 or i == steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = i
                m["elapsed_s"] = time.perf_counter() - t0
                self.history.append(m)
                if log_fn:
                    log_fn(f"step {i:5d} loss={m['loss']:.4f} ppl={m['ppl']:.1f} "
                           f"lr={m['lr']:.2e} gnorm={m['grad_norm']:.2f}")
        return self.history
