"""Host-side sampler worker pool — the disaggregated decision plane behind
``DecisionPlaneClient`` (DESIGN.md §12/§13).

The paper's structural claim (§1, Eq. 4) is that sampling neither expands
with TP nor balances across PP stages: executed on the accelerator it
caps the step rate. SIMPLE moves the draw to a *pool of host samplers*:
the step's logits cross to the host and ``m`` CPU worker threads run
**sequence-parallel shards** (mechanism S1 across workers — each worker
owns a contiguous slice of the batch's rows, the vocabulary whole per
shard) through a CPU :class:`~repro_torch.core.decision_plane.DecisionPlane`
(same seed, k_cap, SHVS config and hot set as the engine's), so every
registered :class:`~repro_torch.core.sampler_backend.SamplerBackend` works
unchanged. On the CPU the backends run the kernels' plain versions
(``kernels/ref.py``; ``shvs`` its CPU twin of the mass pass).

**The D2H seam.** A :class:`~repro_torch.device.HostCopy` of the logits
is made by the thread that enqueued the forward, right after it: a
``non_blocking`` copy of the (B, V) f32 logits into pinned host memory and
a CUDA event recorded behind it. A worker waits on that event only
(``transfer_time``), never on the stream, so work enqueued after the
forward is not in its way. The copy keeps the pinned buffer alive until
every shard is done with it.

Determinism: each row's uniforms come from the plane's counter-based
(request, position) keys and every other per-row computation — penalties,
filtering, the backend draw, the Eq. 5 histogram update — is row-local,
so the sampled stream does not depend on the worker count, and on the CPU
it is the engine's own device-mode stream bit for bit. The one exception
is the ``gumbel`` backend, whose noise is keyed on a row's index in its
operand, i.e. in its shard (ROADMAP 'Faults' 3, as in the reference).

``submit`` returns a :class:`SampleTicket` at once; the caller blocks only
in :meth:`SampleTicket.result`, one overlapped step later. That block is
the paper's "sampler pool too slow for the slack" stall; a worker's wait
for the logits and its CPU sampling are timed apart (``transfer_time`` vs
``sampler_time``).
"""
from __future__ import annotations

import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import penalties as pen
from repro_torch.core.decision_plane import DecisionPlane
from repro_torch.core.sampling import SamplingParams
from repro_torch.core.shvs import HotSet
from repro_torch.device import HostCopy
from repro_torch.models.transformer import stage_bounds
from repro_torch.obs.tracer import NULL_TRACER, StepTracer


class PoolResult(NamedTuple):
    """One batch's assembled sampling outcome.

    ``sampler_time`` and ``transfer_time`` are accounted separately: a
    worker's clock on the *sampling* critical path starts only after its
    wait for the logits returns, so waiting on an in-flight forward
    (device compute + D2H copy) never masquerades as CPU sampling cost.
    """

    tokens: np.ndarray           # (R,) int32; inactive rows are 0
    state: pen.PenaltyState      # updated (R, V) histogram rows, on the CPU
    accept_rate: float
    alpha_mean: float
    fallback_rate: float
    sampler_time: float          # max worker CPU-sampling wall time (s) —
    #                              the pool's critical path, fetch excluded
    transfer_time: float         # max worker wait for the logits (s):
    #                              in-flight compute + D2H copy
    active_rows: int             # rows that actually sampled this call


def _shard_bounds(rows: int, workers: int) -> List[tuple]:
    """Contiguous row ranges: ``min(workers, rows)`` near-equal shards."""
    return stage_bounds(rows, max(1, min(workers, rows)))


class _ShardResult(NamedTuple):
    """One worker's slice of a batch."""

    tokens: np.ndarray
    state: pen.PenaltyState
    stats: tuple                 # (accept_rate, alpha_mean, fallback_rate)
    active_rows: int
    transfer_time: float
    sampler_time: float


class SampleTicket:
    """Pending sampled tokens for one batch (one future per shard).

    ``result()`` blocks until every shard worker finishes and assembles the
    full-batch :class:`PoolResult`; ``done`` is a non-blocking probe.
    """

    def __init__(self, futures: List[Future]):
        self._futures = futures

    @property
    def done(self) -> bool:
        return all(f.done() for f in self._futures)

    def wait(self) -> None:
        """Join every shard worker without assembling the result — the
        drain step of the client's mode-switch / resize discipline (§15):
        after this, no worker thread is still reading the pool's plane."""
        for f in self._futures:
            f.result()

    def result(self) -> PoolResult:
        parts: List[_ShardResult] = [f.result() for f in self._futures]
        tokens = np.concatenate([p.tokens for p in parts])
        state = pen.PenaltyState(
            prompt_counts=torch.cat([p.state.prompt_counts for p in parts]),
            output_counts=torch.cat([p.state.output_counts for p in parts]))
        return PoolResult(tokens=tokens, state=state,
                          **_pool_stats(parts),
                          sampler_time=max(p.sampler_time for p in parts),
                          transfer_time=max(p.transfer_time for p in parts),
                          active_rows=sum(p.active_rows for p in parts))


def _pool_stats(parts: List["_ShardResult"]) -> dict:
    """Pool shard stats weighted by ACTIVE rows, not shard width.

    A mostly-drained batch has shards whose rows are nearly all inactive;
    width-weighting those shards' means skews the pooled ``alpha_mean``
    that feeds the SHVS autotuner. Shards with zero active rows carry zero
    weight (their backend means are meaningless — possibly NaN — and must
    not propagate); with no active rows anywhere the stats are NaN, which
    :class:`repro_torch.core.autotune.HotSizeController` ignores.
    """
    total = float(sum(p.active_rows for p in parts))
    if total == 0.0:
        return {"accept_rate": float("nan"), "alpha_mean": float("nan"),
                "fallback_rate": float("nan")}
    wmean = lambda idx: float(sum(
        p.active_rows * float(p.stats[idx])
        for p in parts if p.active_rows) / total)
    return {"accept_rate": wmean(0), "alpha_mean": wmean(1),
            "fallback_rate": wmean(2)}


def _rows(x, lo: int, hi: int):
    return None if x is None else x[lo:hi]


class HostSamplerPool:
    """``m`` CPU sampler workers behind the decision-plane service.

    ``submit`` shards a batch's rows across the workers (sequence-parallel,
    S1) and returns a ticket; ``sample_sync`` runs the identical math
    full-width on the calling thread.

    The workers run a CPU plane cloned from the engine's ``plane`` at
    every :meth:`refresh` — same seed, k_cap, SHVS config and CURRENT hot
    set (its mask and ids copied to the CPU) — so its uniforms and
    histograms are bit-compatible with the engine's, and autotune hot-set
    swaps propagate through the ordinary refresh hook.
    ``backend_override`` selects a different registered backend for the
    POOL only (e.g. ``"fused"``: its plain version then runs on the
    workers while the engine's plane keeps its algorithm). Unknown names
    fail at construction (the registry's ``ValueError``), not on a worker
    thread mid-serve.
    """

    def __init__(self, plane: DecisionPlane, num_workers: int = 2,
                 backend_override: Optional[str] = None,
                 tracer: Optional[StepTracer] = None):
        self.plane = plane
        self.backend_override = backend_override
        self.num_workers = max(1, num_workers)
        # the owning engine's flight recorder (§17): workers record their
        # d2h_transfer / host_sample spans on their own thread tracks
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._ex: Optional[ThreadPoolExecutor] = None
        self._closed = False
        self.refresh()

    def refresh(self) -> None:
        """Rebuild the workers' CPU plane from the engine's plane. Call
        after the plane's configuration changed under the pool — e.g. the
        SHVS autotuner swapping ``hot_set`` — once in-flight shards have
        been joined."""
        src = self.plane
        hot = src.hot_set
        if hot is not None:
            hot = HotSet(indices=hot.indices.cpu(), mask=hot.mask.cpu())
        self.cpu_plane = DecisionPlane(
            src.vocab_size, algorithm=self.backend_override or src.algorithm,
            shvs=src.shvs_cfg, hot_set=hot, k_cap=src.k_cap, seed=src.seed,
            device="cpu")

    # -- worker body ---------------------------------------------------------
    def _fetch(self, logits: HostCopy, lo: int, hi: int) -> torch.Tensor:
        """The disaggregation boundary: the shard's logits on the host.
        Waits for the copy enqueued at dispatch — a separate seam so that
        wait is timed (and testable) apart from the CPU sampling."""
        return logits.wait()[0][lo:hi]

    def _run_shard(self, lo: int, hi: int, logits: HostCopy, state,
                   params: SamplingParams, bias, nonces, pos, step,
                   active) -> _ShardResult:
        t0 = time.perf_counter()
        shard = self._fetch(logits, lo, hi)
        t1 = time.perf_counter()     # sampling clock starts AFTER the fetch
        act = torch.from_numpy(np.ascontiguousarray(active[lo:hi]))
        tokens, new_state, stats = self.cpu_plane.step(
            shard, pen.PenaltyState(*(s[lo:hi] for s in state)),
            SamplingParams(*(_rows(f, lo, hi) for f in params)), step,
            active=act, rng_tags=(nonces[lo:hi], pos[lo:hi]),
            logit_bias=_rows(bias, lo, hi))
        toks = torch.where(act, tokens, 0).numpy()
        stats_host = (float(stats.accept_rate), float(stats.alpha_mean),
                      float(stats.fallback_rate))
        t2 = time.perf_counter()
        if self.tracer.enabled:
            # same stamps as the returned decomposition: the trace and the
            # stats stream can never disagree about where the time went
            self.tracer.add("d2h_transfer", t0, t1,
                            name=f"fetch[{lo}:{hi}]", step=int(step))
            self.tracer.add("host_sample", t1, t2,
                            name=f"sample[{lo}:{hi}]", step=int(step))
        return _ShardResult(tokens=toks, state=new_state, stats=stats_host,
                            active_rows=int(np.count_nonzero(active[lo:hi])),
                            transfer_time=t1 - t0,
                            sampler_time=t2 - t1)

    # -- client surface ------------------------------------------------------
    def submit(self, logits, state: pen.PenaltyState, params: SamplingParams,
               bias, nonces: np.ndarray, pos: np.ndarray, step: int,
               active: np.ndarray) -> SampleTicket:
        """Dispatch one batch's rows to the worker shards.

        ``logits``: (R, V) f32 — a :class:`~repro_torch.device.HostCopy`
        of them, or the tensor, whose copy is then started here, on the
        calling thread's stream.
        ``state``/``params``/``bias`` are CPU tensors and
        ``nonces``/``pos``/``active`` host arrays: snapshots taken at
        dispatch that nothing writes to while the shards run.
        """
        if self._closed:
            # the executor is created lazily, so without this guard a
            # submit after close() would silently restart worker threads
            raise RuntimeError("HostSamplerPool is closed")
        if not isinstance(logits, HostCopy):
            logits = HostCopy(logits)
        if self._ex is None:
            self._ex = ThreadPoolExecutor(
                max_workers=self.num_workers,
                thread_name_prefix="host-sampler")
        bounds = _shard_bounds(logits.vals[0].shape[0], self.num_workers)
        futures = [self._ex.submit(self._run_shard, lo, hi, logits, state,
                                   params, bias, nonces, pos, step, active)
                   for lo, hi in bounds]
        return SampleTicket(futures)

    def sample_sync(self, logits, state, params, bias, nonces, pos, step,
                    active) -> PoolResult:
        """Full-width draw on the calling thread: the same decision
        program, blocking the caller on the result."""
        if not isinstance(logits, HostCopy):
            logits = HostCopy(logits)
        R = logits.vals[0].shape[0]
        part = self._run_shard(0, R, logits, state, params, bias, nonces,
                               pos, step, active)
        return PoolResult(tokens=part.tokens, state=part.state,
                          **_pool_stats([part]),
                          sampler_time=part.sampler_time,
                          transfer_time=part.transfer_time,
                          active_rows=part.active_rows)

    def resize(self, num_workers: int) -> None:
        """Change the worker count online (the §15 controller's pool-sizing
        knob). Joins any in-flight shard work — ``shutdown(wait=True)``
        drains the executor's queue, and completed futures keep their
        results, so outstanding tickets still resolve — then recycles the
        executor lazily at the new width on the next submit. Sharding is
        row-local (S1), so the worker count never moves a stream."""
        n = max(1, int(num_workers))
        if n == self.num_workers:
            return
        if self._ex is not None:
            self._ex.shutdown(wait=True)
            self._ex = None
        self.num_workers = n

    def close(self) -> None:
        """Idempotent: joins in-flight shards on the first call; later
        calls are no-ops."""
        self._closed = True
        if self._ex is not None:
            self._ex.shutdown(wait=True)
            self._ex = None
