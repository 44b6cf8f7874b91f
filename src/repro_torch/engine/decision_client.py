"""Unified decision-plane client — one sampling seam for the engine
(DESIGN.md §13).

The engine speaks to the decision plane through this client, in one of
two modes:

* ``device`` — the decision executes on the engine's device, inside the
  decode step (the §2 overlapped loop): on a card, the CUDA kernels
  (the reference pipeline's historic spelling is
  ``sampler_mode="baseline"``).
* ``host`` — the paper's disaggregation: the step's logits are copied to
  pinned host memory behind the forward and a
  :class:`~repro_torch.core.host_sampler.HostSamplerPool` of CPU workers
  runs sequence-parallel row shards through a CPU
  :class:`~repro_torch.core.decision_plane.DecisionPlane`. ``submit``
  never blocks; the engine collects the :class:`SampleTicket` one step
  later, so CPU sampling for step *t* overlaps the host-side work — and
  the device compute — of step *t+1* (historically
  ``sampler_mode="disaggregated"``).

Every per-row decision computation (penalties, filters, the backend draw,
the Eq. 5 histogram update) is row-local and uniforms are keyed on
(request, position), so neither the worker sharding nor the commit timing
can move any request's stream: on the CPU the two modes are bit-identical
(``tests/test_torch_host.py``). On a card device mode runs the kernels and
host mode their CPU versions, which agree on greedy rows and may round
sums differently elsewhere.
"""
from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.decision_plane import DecisionPlane
from repro_torch.core.host_sampler import (HostSamplerPool, PoolResult,
                                           SampleTicket)
from repro_torch.device import to_device
from repro_torch.obs.tracer import StepTracer

#: accepted ``sampler_mode`` spellings -> canonical client mode. The
#: pipeline's original names stay valid so existing configs don't break.
SAMPLER_MODES = {
    "device": "device",
    "host": "host",
    "baseline": "device",
    "disaggregated": "host",
}


def canonical_sampler_mode(mode: str) -> str:
    """Map a ``sampler_mode`` spelling to ``device`` | ``host``; unknown
    names raise a ``ValueError`` listing the accepted spellings."""
    try:
        return SAMPLER_MODES[mode]
    except KeyError:
        raise ValueError(
            f"unknown sampler_mode {mode!r}; expected one of "
            f"{sorted(SAMPLER_MODES)}") from None


class DecisionPlaneClient:
    """The engines' handle on the (possibly remote) decision plane.

    Thin by design: the sharding, RNG, and assembly live in
    :class:`HostSamplerPool`; the client owns mode selection, the worker
    pool's lifecycle, and the refresh hook the autotuner needs. The pool's
    executor threads are started lazily on the first host-mode ``submit``,
    so a device-mode client costs nothing.

    ``pool_algorithm`` applies a pool-level backend override: host-mode
    workers draw with that registered backend (e.g. ``fused``, whose
    single-pass plain version then runs on the CPU) while the engine's own plane keeps its configured
    algorithm — the ``--pool-algorithm`` serving knob (DESIGN.md §14).
    """

    def __init__(self, plane: DecisionPlane, mode: str = "device",
                 workers: int = 2, pool_algorithm: Optional[str] = None,
                 tracer: Optional[StepTracer] = None):
        self.mode = canonical_sampler_mode(mode)
        self.plane = plane
        # the engine's flight recorder rides through to the pool workers
        # (§17) so their fetch/sample spans land in the same trace
        self.pool = HostSamplerPool(plane, workers,
                                    backend_override=pool_algorithm,
                                    tracer=tracer)
        self._tickets: List[SampleTicket] = []   # outstanding host work

    @property
    def is_host(self) -> bool:
        return self.mode == "host"

    # -- the async surface ---------------------------------------------------
    def submit(self, logits, state, params, bias, nonces: np.ndarray,
               pos: np.ndarray, step: int,
               active: np.ndarray) -> SampleTicket:
        """Dispatch one batch's sampling to the host pool (host mode).
        Never blocks: ``logits`` may still be in flight on the device —
        the pool's workers wait for its copy, not the caller."""
        assert self.is_host, "submit() is the host-mode path"
        ticket = self.pool.submit(logits, state, params, bias, nonces, pos,
                                  step, active)
        # track outstanding tickets so a mode switch / pool resize can
        # drain them (bounded: prune landed work — at most the engines'
        # in-flight depth, 1 step or M microbatches, survives a prune)
        self._tickets = [t for t in self._tickets if not t.done]
        self._tickets.append(ticket)
        return ticket

    def drain(self) -> None:
        """Join every outstanding ticket's shard workers. Callers that hold
        the tickets still own installing their results; this only
        guarantees no worker thread is mid-shard."""
        for t in self._tickets:
            t.wait()
        self._tickets = []

    def set_mode(self, mode: str) -> bool:
        """Re-route the sampling seam online (DESIGN.md §15): switch
        between the fused on-device decision and the host pool. Drains the
        in-flight ticket(s) BEFORE re-routing — the same join-before-refresh
        discipline as hot-set swaps (§13) — so a dispatched step always
        completes under the placement it was dispatched with, and
        bit-identity survives mid-run switches. Returns True iff the mode
        changed. The engines' own commit bookkeeping is per-dispatch
        (``_Pending.kind`` / per-microbatch tickets), so mixed-placement
        in-flight work commits correctly on either side of the switch."""
        mode = canonical_sampler_mode(mode)
        if mode == self.mode:
            return False
        self.drain()
        self.mode = mode
        return True

    def resize_pool(self, workers: int) -> None:
        """Resize the host sampler pool online (the §15 controller's
        second knob); drains outstanding tickets first so no in-flight
        shard is cancelled by the executor recycle."""
        self.drain()
        self.pool.resize(workers)

    def sample_sync(self, logits, state, params, bias, nonces, pos, step,
                    active) -> PoolResult:
        """Full-width draw through the engine's plane, on its device, on
        the calling thread: the device-mode path for an engine that does
        not fuse the decision into its forward (the pipeline's last-stage
        Eq. 4 baseline). ``logits``, ``state``, ``params`` and ``bias``
        lie on the plane's device, ``nonces``/``pos``/``active`` are host
        arrays. Blocks until the tokens are on the host; the new state
        stays on the device. ``sampler_time`` is the whole draw, the
        device's time included; nothing is transferred but the tokens."""
        t0 = time.perf_counter()
        act = to_device(active, self.plane.device)
        tokens, state, stats = self.plane.step(
            logits, state, params, step, active=act, rng_tags=(nonces, pos),
            logit_bias=bias)
        tokens = torch.where(act, tokens, 0)
        R = tokens.shape[0]
        vals = torch.cat([tokens.float(), torch.stack(
            [s.float() for s in stats])]).cpu().numpy()   # one sync
        return PoolResult(
            tokens=vals[:R].astype(np.int32), state=state,
            accept_rate=float(vals[R]), alpha_mean=float(vals[R + 1]),
            fallback_rate=float(vals[R + 2]),
            sampler_time=time.perf_counter() - t0, transfer_time=0.0,
            active_rows=int(np.count_nonzero(active)))

    # -- lifecycle -----------------------------------------------------------
    def refresh(self) -> None:
        """Rebuild the pool's CPU plane after the engine plane's
        configuration changed under it (the SHVS autotuner swapping
        ``hot_set`` re-shapes the backend's operands)."""
        self.pool.refresh()

    def close(self) -> None:
        """Shut down the worker pool; blocks until in-flight shards land."""
        self.pool.close()


__all__ = ["DecisionPlaneClient", "SAMPLER_MODES", "canonical_sampler_mode",
           "PoolResult", "SampleTicket"]
