"""The DecisionPlane service — SIMPLE's disaggregated sampling plane (§4.2).

The plane is a *service shell* around a pluggable
:class:`~repro_torch.core.sampler_backend.SamplerBackend` selected by name
from the backend registry. The shell owns what is common to all backends:

  S1  sequence-parallel re-shard            (sequence_parallel.py)
  RNG pre-generated per-request uniforms    (core/rng.py, on the host)
  penalties + per-request logit bias        (penalties.py, §4)
  constrained-decoding allow masks
  histogram (Eq. 5) state updates

— while the logits→token draw itself is the backend.

``sampling_parallelism`` places the decision on a mesh
(``models/dist.py``): "sequence_parallel" (S1: every rank a sampler of
whole rows), "vocab_gather" (the baseline: V gathered, the data rows
decided) or "hierarchical" (``core/hierarchical.py``: decided in place
on the LM head's (B/dp, V/t) blocks). Without a mesh every mode is the
identity. Under a mesh :meth:`DecisionPlane.step` takes a rank's blocks:
the logits (and ``logit_bias``/``allow_mask``) as the LM head leaves
them; ``params``, ``active`` and ``rng_tags`` for the global batch,
which the plane cuts to the rank's rows; the state in the layout of
``launch/sharding.decision_state_shardings``, in which it comes back.
The tokens come back for the rank's data rows, equal on every model
rank; the stats are means over the rank's decision rows.

For backends that do not fuse penalties, the penalty pass is
``ops.fused_penalty_scale`` with τ = 1: the ``penalty_scale`` kernel on a
CUDA tensor, its plain version on the CPU. ``z / max(1, 1e-6)`` is exact,
so the result is ``apply_penalties_rows``.

Determinism: uniforms come from counter-based keys — ``fold_in(seed,
step)`` standalone, or ``fold_in(fold_in(seed, request), position)`` when
the engine passes ``rng_tags`` — bit-equal to the reference package's
``jax.random`` draws. A request carrying its own seed draws from
``fold_in(fold_in(PRNGKey(seed), tag), position)`` instead.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.config import SHVSConfig
from repro_torch.core import penalties as pen
from repro_torch.core import rng
from repro_torch.core.hierarchical import (block_hot_columns,
                                           hierarchical_sample)
from repro_torch.core.sampler_backend import (DecisionStats, SamplerBackend,
                                              make_backend,
                                              registered_backends)
from repro_torch.core.sampling import SamplingParams
from repro_torch.core.sequence_parallel import (gather_tokens,
                                                reshard_for_sampling,
                                                sampler_axes,
                                                shard_decision_state)
from repro_torch.core.shvs import HotSet
from repro_torch.device import resolve_device, to_device
from repro_torch.kernels import ops
from repro_torch.models import dist

MODES = ("sequence_parallel", "vocab_gather", "hierarchical")


class DecisionPlane:
    """Stateless-per-step sampling service speaking the backend protocol.

    ``algorithm`` selects a registered backend by name; an unknown name
    raises the registry's ``ValueError`` at construction and at
    :meth:`step`.
    """

    def __init__(self, vocab_size: int, *, algorithm: str = "shvs",
                 shvs: SHVSConfig = SHVSConfig(),
                 hot_set: Optional[HotSet] = None,
                 sampling_parallelism: str = "sequence_parallel",
                 k_cap: int = 1024, seed: int = 0, device="cuda"):
        if sampling_parallelism not in MODES:
            raise ValueError(f"unknown sampling parallelism "
                             f"{sampling_parallelism!r}; one of {MODES}")
        self.vocab_size = vocab_size
        self.algorithm = algorithm
        self.shvs_cfg = shvs
        self.hot_set = hot_set
        self.parallelism = sampling_parallelism
        # hierarchical mode: (hot set, mesh, this rank's block's hot columns)
        self._hot_cols = None
        self.k_cap = k_cap
        self.seed = seed
        self.device = resolve_device(device)
        self._backend: Optional[SamplerBackend] = None
        self._backend_key = None
        self._resolve_backend()        # fail fast on unknown algorithm names

    def _resolve_backend(self) -> SamplerBackend:
        """The backend for the current (algorithm, hot_set) configuration,
        re-resolved lazily so post-init mutation takes effect."""
        key = (self.algorithm, id(self.hot_set))
        if self._backend is None or self._backend_key != key:
            self._backend = make_backend(
                self.algorithm, vocab_size=self.vocab_size, k_cap=self.k_cap,
                seed=self.seed, shvs=self.shvs_cfg, hot_set=self.hot_set,
                device=self.device)
            self._backend_key = key
            if self.hot_set is None and hasattr(self._backend, "hot_set"):
                # surface the backend's default hot set
                self.hot_set = self._backend.hot_set
                self._backend_key = (self.algorithm, id(self.hot_set))
        return self._backend

    # -- state ---------------------------------------------------------------
    def init_state(self, batch: int, prompt_tokens=None, prompt_lens=None
                   ) -> pen.PenaltyState:
        return self._resolve_backend().init_state(
            batch, self.vocab_size, prompt_tokens, prompt_lens,
            device=self.device)

    def uniforms(self, step, batch: int) -> np.ndarray:
        """Deterministic (B, 3) uniforms for (accept, hot, tail) draws."""
        return rng.uniforms(self.seed, int(step), batch)

    def uniforms_tagged(self, nonces, positions, seeds=None, use_seed=None
                        ) -> np.ndarray:
        """Per-request (B, 3) uniforms: row b draws from
        ``fold_in(fold_in(seed, nonce_b), pos_b)``, or, where ``use_seed``,
        from ``fold_in(fold_in(PRNGKey(seeds_b), tag), pos_b)``. All
        arguments are host arrays."""
        return rng.uniforms_tagged(self.seed, nonces, positions, seeds,
                                   use_seed)

    # -- the per-iteration decision ------------------------------------------
    def step(self, logits: torch.Tensor, state: pen.PenaltyState,
             params: SamplingParams, step_idx, active=None, allow_mask=None,
             rng_tags=None, logit_bias=None, uniforms=None):
        """logits: (B, V) f32 from the LM head. Returns (tokens, state,
        stats).

        ``allow_mask``: optional (B, V) bool — disallowed tokens are masked
        to −1e30 before the filter pipeline.
        ``rng_tags``: optional host ``(nonces (B,), positions (B,))`` —
        draw per-request uniforms instead of the per-iteration stream
        keyed on ``step_idx``.
        ``logit_bias``: optional (B, V) f32 added before penalties.
        ``uniforms``: optional (B, 3) f32 tensor of uniforms already drawn
        (by :meth:`uniforms_tagged`, for the global batch) and on the
        device; it replaces the host draw, so the step reads nothing from
        the host and can be captured in a CUDA graph.
        """
        # the global batch: params come for all of it under a mesh
        B = params.temperature.shape[0] if dist.get_ctx().active \
            else logits.shape[0]
        backend = self._resolve_backend()   # ValueError on unknown algorithm
        if logit_bias is not None:
            logits = logits + logit_bias
        if allow_mask is not None:
            logits = torch.where(allow_mask, logits, -1e30)
        if uniforms is not None:
            u = uniforms
        elif rng_tags is not None:
            u = self.uniforms_tagged(*rng_tags, seeds=params.seed,
                                     use_seed=params.use_seed)
        else:
            u = self.uniforms(step_idx, B)
        core = params.strip_rng()   # backends speak the 7-field core struct
        mode = self.parallelism
        if mode == "hierarchical" and dist.get_ctx().active:
            # beyond-paper: decide in place on the (B@batch, V@model) blocks
            ctx = dist.get_ctx()
            r0, n = dist.rows(B, ctx.batch_axes)
            sl = slice(r0, r0 + n)
            # the tuple holds the hot set and the mesh (this process's
            # place in it fixes the block), so `is` is sound
            where = (self.hot_set, ctx.mesh)
            if self._hot_cols is None or any(
                    a is not b for a, b in zip(self._hot_cols[:2], where)):
                self._hot_cols = where + (block_hot_columns(
                    self.hot_set, self.vocab_size),)
            tokens, state, res = hierarchical_sample(
                logits, state, core._replace(**{
                    f: getattr(core, f)[sl] for f in core._fields
                    if getattr(core, f) is not None}),
                _on(u[sl], logits.device), self.hot_set,
                k_cap=self.k_cap, vocab=self.vocab_size,
                hot_cols=self._hot_cols[2])
            if active is not None:
                tokens = torch.where(active[sl], tokens, 0)
            stats = DecisionStats(res.accepted.float().mean(),
                                  res.alpha.mean(),
                                  (~res.exact_fast).float().mean())
            return tokens, state, stats
        # S1: re-shard the decision plane along the batch axis (the
        # identity without a mesh)
        logits = reshard_for_sampling(logits, mode, B, self.vocab_size)
        u = _on(shard_decision_state(u, mode, B), logits.device)
        core = shard_decision_state(core, mode, B)
        active = shard_decision_state(active, mode, B)
        row0 = dist.rows(B, sampler_axes(mode))[0]
        kw = {"row0": row0} if backend.keys_rows else {}
        if backend.fuses_penalties:
            # the backend applies Eq. 1 inside its own single pass
            tokens, stats = backend.step(logits, core, u, step_idx=step_idx,
                                         state=state, **kw)
        else:
            z = ops.fused_penalty_scale(
                logits, state.prompt_counts, state.output_counts,
                core.repetition_penalty, core.presence_penalty,
                core.frequency_penalty, torch.ones_like(core.temperature))
            tokens, stats = backend.step(z, core, u, step_idx=step_idx, **kw)
        state = pen.update_histograms(state, tokens, active)
        return gather_tokens(tokens, mode, B), state, stats


def _on(u, device) -> torch.Tensor:
    """Uniforms drawn on the host (an array) or handed in (a tensor) as a
    tensor on ``device``."""
    return u.to(device) if isinstance(u, torch.Tensor) else \
        to_device(u, device)


__all__ = ["DecisionPlane", "DecisionStats", "registered_backends"]
