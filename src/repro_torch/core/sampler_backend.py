"""Pluggable sampler backends — the decision-plane service API v1.

* :class:`SamplerBackend` — the protocol. A backend is a stateless
  logits→token draw: ``init_state`` builds the per-batch penalty state,
  ``step(z, params, uniforms, step_idx=...)`` turns penalized logits into
  ``(tokens, DecisionStats)``. Uniforms, penalties, histogram updates and
  allow masks belong to the service shell (``DecisionPlane``).
* a **registry** — backends are selected by name
  (:func:`make_backend` / :func:`registered_backends`); an unknown name is
  a ``ValueError`` listing what is registered.

Registered backends:

  ``reference``         full-V masked softmax (the baseline oracle)
  ``truncation_first``  the paper's S2 (truncate → normalize → draw)
  ``shvs``              S2 + S3 speculative hot-vocab sampling
                        (registered by ``repro_torch.core.shvs``)
  ``fused``             the whole decision in one kernel pass — penalties →
                        temperature → truncation-first filter → Gumbel draw
                        (``kernels/csrc/fused.cu``)
  ``gumbel``            single-pass Gumbel-max draw for unfiltered rows
                        (``kernels/csrc/gumbel.cu``), truncation-first for
                        filtered ones

Backends agree bit for bit on greedy rows and single-token supports, and
in distribution elsewhere.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.core import penalties as pen
from repro_torch.core.sampling import (SamplingParams, sample_reference,
                                       temperature_scale,
                                       truncation_first_sample)


class DecisionStats(NamedTuple):
    """Per-step observability emitted by every backend (0-d tensors)."""

    accept_rate: torch.Tensor     # mean fast-path acceptance
    alpha_mean: torch.Tensor      # mean hot-vocab mass (1 when not applicable)
    fallback_rate: torch.Tensor   # fraction of rows that took the full path


class SamplerBackend:
    """Protocol: one interchangeable sampling algorithm.

    Constructors are invoked by the registry with the full service
    configuration as keyword arguments — ``vocab_size``, ``k_cap``,
    ``seed``, ``shvs`` (an ``SHVSConfig``), ``hot_set``, ``device`` — and
    take what they need (``**_`` swallows the rest).
    """

    name: str = "abstract"

    #: a backend that applies Eq. 1 penalties itself, inside its own pass;
    #: the shell then hands it RAW (post-bias/mask) logits plus ``state=``
    fuses_penalties: bool = False
    #: a backend whose draw is keyed on the operand's row index; the shell
    #: then passes ``row0=``, the global index of the operand's first row
    #: (non-zero when a rank decides a block of the batch)
    keys_rows: bool = False
    #: a backend whose draw reads ``step_idx`` as a host integer (a kernel
    #: argument, not a tensor): a CUDA graph captured at one step would
    #: replay that step's value, so the engine runs its decision eagerly
    keys_step: bool = False

    def init_state(self, batch: int, vocab_size: int, prompt_tokens=None,
                   prompt_lens=None, device="cpu") -> pen.PenaltyState:
        """Per-batch decision state (token histograms for Eq. 5)."""
        return pen.init_state(batch, vocab_size, prompt_tokens, prompt_lens,
                              device=device)

    def step(self, z: torch.Tensor, params: SamplingParams,
             uniforms: torch.Tensor, *, step_idx
             ) -> Tuple[torch.Tensor, DecisionStats]:
        """Draw one token per row from penalized (not temperature-scaled)
        logits ``z`` (B, V) f32 with (B, 3) uniforms — (accept, hot, tail).
        Returns ``(tokens (B,) int32, DecisionStats)``."""
        raise NotImplementedError


_REGISTRY: Dict[str, Callable[..., SamplerBackend]] = {}


def register_backend(name: str):
    """Class decorator: register a :class:`SamplerBackend` under ``name``."""

    def deco(factory):
        _REGISTRY[name] = factory
        return factory

    return deco


def _ensure_builtin() -> None:
    # shvs registers its backend on import; imported here (not at module
    # top) because shvs imports this module for the protocol
    from repro_torch.core import shvs  # noqa: F401


def registered_backends() -> Tuple[str, ...]:
    """Names of every registered sampler backend, sorted."""
    _ensure_builtin()
    return tuple(sorted(_REGISTRY))


def make_backend(name: str, **kwargs) -> SamplerBackend:
    """Instantiate the backend registered under ``name``; an unknown name
    raises a ``ValueError`` naming the registered backends."""
    _ensure_builtin()
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown sampler backend {name!r}; registered backends: "
            f"{', '.join(sorted(_REGISTRY))}")
    return _REGISTRY[name](**kwargs)


def _const(x: float, like: torch.Tensor) -> torch.Tensor:
    # a fill on the device: torch.tensor(x, device=...) would copy from
    # the host and synchronise the stream
    return torch.full((), x, device=like.device)


@register_backend("reference")
class ReferenceBackend(SamplerBackend):
    """Full-vocabulary masked softmax — the baseline oracle (§2.1)."""

    name = "reference"

    def __init__(self, **_):
        pass

    def step(self, z, params, uniforms, *, step_idx):
        tokens = sample_reference(z, params, uniforms[:, 1])
        stats = DecisionStats(_const(1.0, z), _const(1.0, z),
                              _const(0.0, z))
        return tokens, stats


@register_backend("truncation_first")
class TruncationFirstBackend(SamplerBackend):
    """The paper's S2: truncate to the filter support, then draw (§5.2)."""

    name = "truncation_first"

    def __init__(self, *, k_cap: int = 1024, **_):
        self.k_cap = k_cap

    def step(self, z, params, uniforms, *, step_idx):
        res = truncation_first_sample(z, params, uniforms[:, 1],
                                      k_cap=self.k_cap)
        stats = DecisionStats(_const(1.0, z), _const(1.0, z),
                              1.0 - res.exact.float().mean())
        return res.tokens, stats


@register_backend("fused")
class FusedBackend(SamplerBackend):
    """The entire decision in ONE kernel pass: penalties → temperature →
    streaming top-K/masses → truncation-first filter → restricted
    Gumbel-max draw, reading the (B, V) logits with no (B, V) intermediate
    (``kernels/csrc/fused.cu``; on the CPU its tile-faithful plain
    version).

    ``fuses_penalties`` makes the shell hand this backend raw logits plus
    the histogram state. ``hot_set`` defaults exactly like the ``shvs``
    backend's, so the pass reports the same α statistic.
    """

    name = "fused"
    fuses_penalties = True

    def __init__(self, *, vocab_size: int, k_cap: int = 1024, shvs=None,
                 hot_set=None, block_v: int = 2048, device="cpu", **_):
        if hot_set is None:
            from repro_torch.config import SHVSConfig
            from repro_torch.core.shvs import make_hot_set
            cfg = shvs if shvs is not None else SHVSConfig()
            H = cfg.resolve_hot_size(vocab_size)
            hot_set = make_hot_set(torch.arange(H), vocab_size, device)
        self.hot_set = hot_set
        self.k_cap = k_cap
        self.block_v = block_v

    def step(self, z, params, uniforms, *, step_idx, state):
        from repro_torch.kernels import ops
        tokens, exact, alpha, kept = ops.fused_sample(
            z, state.prompt_counts, state.output_counts, params,
            uniforms[:, 1].contiguous(), self.hot_set.mask, k_cap=self.k_cap,
            block_v=self.block_v)
        stats = DecisionStats(_const(1.0, z), alpha.mean(),
                              1.0 - exact.float().mean())
        return tokens, stats


@register_backend("gumbel")
class GumbelBackend(SamplerBackend):
    """Single-pass sampler: unfiltered rows draw ``argmax(z/τ + Gumbel)``
    in one read of the logits (``ops.fused_gumbel_argmax``: the
    ``gumbel_argmax`` kernel on CUDA); filtered rows take the
    truncation-first path. As in the reference, both draws run for every
    row and the row's controls select.

    The Gumbel noise is keyed on ``(seed, step_idx)`` and the batch row
    (``row0`` plus the operand's row, so a rank deciding rows of a larger
    batch draws their noise): reproducible run to run, but not invariant
    to the schedule. ``seed32``
    wraps in int32 as the reference's does; the kernel takes its uint32
    bits, so ``step_idx`` must be a host integer (never read back from the
    device).
    """

    name = "gumbel"
    keys_rows = True
    keys_step = True

    def __init__(self, *, k_cap: int = 1024, seed: int = 0, **_):
        self.k_cap = k_cap
        self.seed = seed

    def step(self, z, params, uniforms, *, step_idx, row0: int = 0):
        from repro_torch.kernels import ops
        zs = temperature_scale(z, params.temperature)
        seed32 = (int(self.seed) * 1000003 + int(step_idx)) & 0xFFFFFFFF
        fast = ops.fused_gumbel_argmax(zs, seed32, row0) if row0 \
            else ops.fused_gumbel_argmax(zs, seed32)
        res = truncation_first_sample(z, params, uniforms[:, 1],
                                      k_cap=self.k_cap)
        has_filter = (params.top_k > 0) | (params.top_p < 1.0) | \
            (params.min_p > 0.0)
        greedy = zs.argmax(-1).to(torch.int32)
        tokens = torch.where(params.temperature <= 0.0, greedy,
                             torch.where(has_filter, res.tokens, fast))
        stats = DecisionStats((~has_filter).float().mean(), _const(1.0, z),
                              (has_filter & ~res.exact).float().mean())
        return tokens, stats
