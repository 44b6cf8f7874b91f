"""Training loop: loss, train-step factory, the Trainer.

One step is the reference's ``jax.value_and_grad`` of :func:`loss_fn`
as ``torch.autograd.grad`` over the parameter leaves, then
:func:`~repro_torch.training.optimizer.adamw_update`. The parameters a
step returns are new tensors that do not require grad, so they can be
handed to an ``Engine`` as they are.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.training.optimizer import (adamw_init, adamw_update,
                                            tree_leaves, tree_map,
                                            tree_unflatten)


def loss_fn(model: Model, params, batch, cfg: TrainConfig,
            remat: bool = True):
    """Cross-entropy + z-loss + MoE aux. batch: tokens/labels (B, S), plus
    the VLM's ``patch_embeds`` or whisper's ``frames``."""
    logits, aux = model.train_logits(params, batch, remat=remat)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, batch["labels"].long()[..., None])[..., 0]
    ce = (lse - ll).mean()
    z_loss = cfg.z_loss_weight * torch.square(lse).mean()
    total = ce + z_loss + aux
    metrics = {"loss": total, "ce": ce, "z_loss": z_loss, "moe_aux": aux,
               "ppl": torch.exp(torch.clamp(ce, max=20.0))}
    return total, metrics


def grads_of(model: Model, params, batch, cfg: TrainConfig,
             remat: bool = True):
    """(loss, metrics, grads): ``loss_fn`` and its gradient with respect
    to every parameter leaf, a tree shaped as ``params`` (zeros where a
    leaf does not reach the loss)."""
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    leaves = tree_leaves(live)
    loss, metrics = loss_fn(model, live, batch, cfg, remat=remat)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_unflatten(params, grads)


def make_train_step(model: Model, cfg: TrainConfig) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics)."""

    def train_step(params, opt_state, batch):
        _, metrics, grads = grads_of(model, params, batch, cfg,
                                     remat=cfg.remat)
        params, opt_state, opt_metrics = adamw_update(params, grads,
                                                      opt_state, cfg)
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
