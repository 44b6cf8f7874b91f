"""Pipeline-parallel serving: microbatched multi-stage decode with the
decision plane in the host sampler pool (DESIGN.md §12).

The paper's Eq. 4 argument: sampling executed on the last pipeline stage
caps the pipeline frequency, idling every other stage ``t_sampling`` a
cycle. This module makes it executable:

* **stage split** — the layer stack is sliced into ``p`` contiguous
  stages (``models.transformer.stage_bounds`` / ``slice_stage_params``),
  each with its own layer slice of the KV cache (contiguous slabs or paged
  pools); the input embedding rides on stage 1 and the tied LM head on
  stage ``p`` (``Model.decode_stage``);
* **microbatches + cycle clock** — the ``B`` batch slots are partitioned
  into ``M ≥ p`` microbatch groups of ``R = B/M`` rows. An explicit cycle
  clock (:class:`MicrobatchPlanner`) round-robins them: at cycle ``c``
  stage ``s`` serves microbatch ``(c − s) mod M``, the activations handed
  from stage to stage;
* **disaggregated sampling** — the last stage's logits go to the
  :class:`~repro_torch.core.host_sampler.HostSamplerPool` of CPU workers
  (a ``non_blocking`` copy into pinned memory behind the forward) and the
  sampled tokens are **committed only when the microbatch re-enters stage
  1**, ``(M − p)`` cycles later — the paper's slack. The pipeline stalls
  only if the pool cannot make that slack, and the stall is measured
  (``cycle_log``). ``sampler_mode="baseline"`` instead draws synchronously
  on the device right after the last stage's forward, through the
  engine's own plane (the CUDA kernels on a card), putting ``t_sampling``
  back on the cycle's critical path for the bubble comparison.

On one device the stages run one after another: a cycle's wall time is
the sum of the stages' busy times plus the stall or the synchronous draw.
:meth:`PipelineEngine.pipeline_report` computes Eq. 4's quantities for
``p`` separate devices (``C = max_s busy_s``, the bubble fraction) from
the measured stage times.

**Identity** (``tests/test_torch_pipeline.py``): for any ``p`` and ``M``
the committed streams equal the single-stage
:class:`~repro_torch.engine.engine.Engine`'s and the reference
``PipelineEngine``'s, because the stages' layer slices compose exactly
like the full stack, every per-row decision is row-local, and uniforms are
keyed on (request, position), so tokens do not depend on the schedule.

Unlike the reference's immutable arrays, K/V are written in place, so
every microbatch owns its cache allocation (a stage's cache is a view of
its layers); the paged pools are shared across microbatches on purpose, as
the global block pool. Scope: full-causal dense/MoE decoders, monolithic
prefill (a prompt runs through all stages in one program), and in paged
mode a *reserving* admission gate (a request enters only when its worst
case fits net of every running request's outstanding worst case), so
in-flight microbatches never need preemption. KV migration is refused.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.core import penalties as pen
from repro_torch.core.decision_plane import DecisionPlane
from repro_torch.core.host_sampler import PoolResult, SampleTicket
from repro_torch.device import HostCopy, resolve_device, to_device
from repro_torch.engine.decision_client import DecisionPlaneClient
from repro_torch.engine.engine import (EngineConfig, SlotParams, _insert_rows,
                                       _move_state, generate_stream,
                                       locked_api, prefill_new_rows,
                                       refuse_encdec)
from repro_torch.engine.paged_cache import (BlockAllocator, PagedCacheConfig,
                                            init_paged_cache)
from repro_torch.engine.request import Request, RequestState
from repro_torch.engine.scheduler import Scheduler
from repro_torch.models.attention import flat_block_indices, scatter_block_kv
from repro_torch.models.model import Model
from repro_torch.models.transformer import (slice_stage_cache,
                                            slice_stage_params, stage_bounds)
from repro_torch.obs import CycleRecord, EngineMetrics, StepRecord, Telemetry


@dataclass
class PipelineConfig(EngineConfig):
    """Engine config plus the pipeline dimensions (DESIGN.md §12)."""

    stages: int = 2                   # p — pipeline stages
    microbatches: int = 0             # M in flight; 0 -> p (minimum legal)
    samplers: int = 2                 # m — host sampler pool workers
    sampler_mode: str = "disaggregated"   # -> client "host"; "baseline"
    #                                   -> "device" (sync, last stage, Eq. 4);
    #                                   "adaptive" -> the controller switches
    #                                   placement / resizes the pool online


@dataclass
class _Dispatch:
    """One microbatch's in-flight token: dispatched at stage 1, sampled at
    stage p, committed at the next stage-1 re-entry."""

    microbatch: int
    dispatch_cycle: int
    active: np.ndarray                       # (R,) bool snapshot
    slot_request: List[Optional[Request]]    # (R,) snapshot at dispatch
    nonces: np.ndarray                       # (R,) uint32 RNG tag snapshot
    positions: np.ndarray                    # (R,) int32 RNG tag snapshot
    exit_cycle: Optional[int] = None         # last-stage forward cycle
    commit_due: Optional[int] = None         # next stage-1 re-entry cycle


class MicrobatchPlanner:
    """Cycle clock + in-flight ledger for the microbatched pipeline.

    The planner owns WHICH microbatch each stage serves each cycle and
    WHEN a sampled token may commit; the engine owns the tensors. It holds
    no device state, so its invariants are checked directly
    (``tests/test_torch_pipeline.py``):

    * slot-group disjointness — a dispatch may only cover its own group's
      slots, and no slot is ever covered by two in-flight dispatches;
    * single in-flight token per microbatch — a microbatch cannot be
      re-dispatched before its previous token committed;
    * commit timing — a token commits exactly at its microbatch's first
      stage-1 re-entry after the last-stage exit (never earlier), i.e.
      ``commit_due = exit_cycle + ((i − exit_cycle) mod M or M)``.
    """

    def __init__(self, stages: int, microbatches: int, rows_per_group: int):
        assert stages >= 1 and rows_per_group >= 1
        assert microbatches >= stages, \
            f"need M >= p microbatches in flight (got M={microbatches}, " \
            f"p={stages})"
        self.p = stages
        self.M = microbatches
        self.R = rows_per_group
        self.cycle = 0
        self.inflight: Dict[int, _Dispatch] = {}

    # -- schedule geometry ---------------------------------------------------
    def group_slots(self, microbatch: int) -> range:
        """Global slot ids owned by ``microbatch`` (fixed partition)."""
        return range(microbatch * self.R, (microbatch + 1) * self.R)

    def stage_for(self, cycle: int, stage: int) -> int:
        """The microbatch stage ``stage`` serves at ``cycle``."""
        return (cycle - stage) % self.M

    def reentry(self, cycle: int) -> int:
        """The microbatch re-entering stage 1 at ``cycle``."""
        return cycle % self.M

    # -- ledger -------------------------------------------------------------
    def dispatch(self, microbatch: int, active: np.ndarray,
                 slot_request: List[Optional[Request]],
                 nonces: np.ndarray, positions: np.ndarray) -> _Dispatch:
        i = microbatch
        assert i == self.reentry(self.cycle), \
            f"microbatch {i} dispatched off-schedule at cycle {self.cycle}"
        assert i not in self.inflight, \
            f"microbatch {i} re-dispatched with a token still in flight"
        mine = set(self.group_slots(i))
        for other in self.inflight.values():
            other_slots = {r.slot for a, r in zip(other.active,
                                                  other.slot_request)
                           if a and r is not None}
            assert not (mine & other_slots), \
                "slot aliased by two in-flight microbatches"
        for a, r in zip(active, slot_request):
            if a:
                assert r is not None and r.slot in mine, \
                    "dispatch covers a slot outside its microbatch group"
        rec = _Dispatch(microbatch=i, dispatch_cycle=self.cycle,
                        active=np.asarray(active, bool).copy(),
                        slot_request=list(slot_request),
                        nonces=np.asarray(nonces).copy(),
                        positions=np.asarray(positions).copy())
        self.inflight[i] = rec
        return rec

    def mark_exit(self, microbatch: int) -> _Dispatch:
        """Last-stage forward done, sampling dispatched: fix the commit
        cycle = the microbatch's next stage-1 re-entry."""
        rec = self.inflight[microbatch]
        assert rec.exit_cycle is None, "microbatch exited twice"
        assert self.stage_for(self.cycle, self.p - 1) == microbatch, \
            "last stage ran off-schedule"
        rec.exit_cycle = self.cycle
        due = (microbatch - self.cycle) % self.M
        rec.commit_due = self.cycle + (due or self.M)
        return rec

    def commit(self, microbatch: int) -> _Dispatch:
        rec = self.inflight.pop(microbatch)
        assert rec.exit_cycle is not None, \
            "token committed before the last-stage forward"
        assert self.cycle >= rec.commit_due, \
            "token committed before its microbatch's re-entry cycle"
        assert self.cycle == rec.commit_due, \
            "commit missed the re-entry cycle it was due at"
        return rec

    def tick(self) -> None:
        self.cycle += 1


@dataclass
class _Microbatch:
    """Per-microbatch state between cycles."""

    x: Optional[torch.Tensor] = None         # activation awaiting stage_next
    stage_next: int = 0
    ticket: Optional[SampleTicket] = None    # pending host-sampled tokens
    ready: Optional[PoolResult] = None       # baseline: sampled synchronously
    block_table: Optional[torch.Tensor] = None   # paged: (R, MB) snapshot


class PipelineEngine:
    """Microbatched ``p``-stage pipeline engine with disaggregated
    sampling (DESIGN.md §12). Drop-in for
    :class:`~repro_torch.engine.engine.Engine` on the service surface:
    ``submit`` / ``step`` / ``run`` / ``flush`` / ``generate`` /
    ``close``. ``device`` defaults to "cuda" and must match where
    ``params`` live."""

    def __init__(self, model_cfg: ModelConfig, params,
                 engine_cfg: PipelineConfig, hot_set=None, device="cuda",
                 telemetry: Optional[Telemetry] = None):
        # first, before anything can raise: the public-API lock and the
        # closed flag that close() reads on a half-constructed engine
        self._api_lock = threading.RLock()
        self._closed = False
        refuse_encdec(model_cfg)
        self.device = resolve_device(device)
        self.cfg = model_cfg
        self.ecfg = engine_cfg
        p = engine_cfg.stages
        M = engine_cfg.microbatches or p
        B = engine_cfg.max_batch
        assert model_cfg.family in ("dense", "moe") \
            and not model_cfg.is_encdec and not model_cfg.sliding_window, \
            "PipelineEngine: full-causal dense/moe decoders only"
        assert engine_cfg.prompt_chunk == 0, \
            "PipelineEngine: chunked prefill not supported (prompts " \
            "prefill through all stages in one program)"
        assert B % M == 0, f"max_batch={B} must divide into M={M} microbatches"
        self.p, self.M, self.R = p, M, B // M
        self.num_slots = B
        self.model = Model(model_cfg)
        self.params = params
        self.bounds = stage_bounds(model_cfg.num_layers, p)
        # stage-sliced parameters (views); the tied embedding table is the
        # same tensor on the first stage (input embed) and the last (LM head)
        self.stage_params: List[dict] = []
        for s, (lo, hi) in enumerate(self.bounds):
            sp = {"stack": slice_stage_params(params["stack"], lo, hi,
                                              last=(s == p - 1))}
            if s == 0 or s == p - 1:
                sp["emb"] = params["emb"]
            self.stage_params.append(sp)
        self.decision = DecisionPlane(
            model_cfg.vocab_size, algorithm=engine_cfg.algorithm,
            shvs=engine_cfg.shvs, hot_set=hot_set,
            sampling_parallelism=engine_cfg.sampling_parallelism,
            k_cap=min(engine_cfg.k_cap, model_cfg.vocab_size),
            seed=engine_cfg.seed, device=self.device)
        # "host" ships last-stage logits to the CPU sampler pool
        # ("disaggregated"); "device" draws synchronously on the last
        # stage's critical path ("baseline", Eq. 4). "adaptive" starts on
        # the host — the pipeline's structural win — and lets the
        # controller fall back to the device or resize the pool online
        self._adaptive = engine_cfg.sampler_mode == "adaptive"
        self.obs = telemetry if telemetry is not None else Telemetry()
        self.tracer = self.obs.tracer
        self._metrics = EngineMetrics(self.obs.metrics)
        self.client = DecisionPlaneClient(
            self.decision,
            "host" if self._adaptive else engine_cfg.sampler_mode,
            engine_cfg.samplers, pool_algorithm=engine_cfg.pool_algorithm,
            tracer=self.tracer)
        self.pool = self.client.pool
        self._metrics.mode_host.set(1.0 if self.client.is_host else 0.0)
        self._metrics.pool_workers.set(float(engine_cfg.samplers))
        self.planner = MicrobatchPlanner(p, M, self.R)
        S = engine_cfg.max_seq_len
        self._paged = engine_cfg.cache == "paged"
        assert engine_cfg.cache in ("contiguous", "paged"), engine_cfg.cache
        dev = self.device
        kv_gate = None
        if self._paged:
            bs = engine_cfg.block_size
            assert S % bs == 0, (
                f"max_seq_len={S} must be a multiple of block_size={bs}")
            mb = S // bs
            self.pcfg = PagedCacheConfig(
                block_size=bs, num_blocks=engine_cfg.num_blocks or B * mb,
                max_blocks_per_seq=mb)
            self.alloc = BlockAllocator(self.pcfg, B)
            self._slot_len = np.zeros((B,), np.int64)
            kv_gate = self._kv_gate
            # per-stage layer slices of one pool pair, shared across
            # microbatches (the block pool is a global resource; block ids
            # are stage-invariant)
            full = init_paged_cache(model_cfg, self.R, self.pcfg, device=dev)
            self.pools = [{"k_pool": full["k_pool"][lo:hi],
                           "v_pool": full["v_pool"][lo:hi]}
                          for lo, hi in self.bounds]
            self.caches = [[{"len": torch.zeros((self.R,), dtype=torch.int32,
                                                device=dev),
                             "pos": torch.zeros((), dtype=torch.int32,
                                                device=dev)}
                            for _ in range(M)] for _ in range(p)]
        else:
            # K/V are written in place: each microbatch owns its allocation,
            # and each stage's cache is a view of its layers with its own
            # lengths
            fulls = [self.model.init_cache(self.R, S, device=dev)
                     for _ in range(M)]
            self.caches = [[self._own_lens(slice_stage_cache(f, lo, hi))
                            for f in fulls] for lo, hi in self.bounds]
        self.scheduler = Scheduler(
            B, prompt_chunk=0,
            priority_admission=engine_cfg.priority_admission,
            max_admission_wait=engine_cfg.max_admission_wait,
            max_prompt=engine_cfg.max_seq_len,
            kv_gate=kv_gate, on_free=self._on_slot_free)
        V = model_cfg.vocab_size
        self._mb = [_Microbatch() for _ in range(M)]
        self.pstate: List[pen.PenaltyState] = [
            _move_state(self.decision.init_state(self.R), self._pstate_home)
            for _ in range(M)]
        self.last_tokens = [np.zeros((self.R,), np.int32) for _ in range(M)]
        self._sp = [SlotParams(self.R, V, dev) for _ in range(M)]
        self._nonce = [np.zeros((self.R,), np.uint32) for _ in range(M)]
        self._pos = [np.zeros((self.R,), np.int32) for _ in range(M)]
        self._draining = False
        # bounded flight logs: StepRecord per commit, CycleRecord per cycle
        self.stats_log: Deque[StepRecord] = deque(
            maxlen=engine_cfg.stats_window)
        self.cycle_log: Deque[CycleRecord] = deque(
            maxlen=engine_cfg.stats_window)
        self._cycle_rec: Optional[CycleRecord] = None
        self._dpc = None
        if self._adaptive:
            from repro_torch.core.autotune import DecisionPlaneController
            self._dpc = DecisionPlaneController(
                mode=self.client.mode, samplers=engine_cfg.samplers,
                queue_high=float(B))

    @staticmethod
    def _own_lens(cache: dict) -> dict:
        cache["len"] = cache["len"].clone()
        cache["pos"] = cache["pos"].clone()
        return cache

    @property
    def _pstate_home(self) -> torch.device:
        """Where the (R, V) histograms live: with the host pool in host
        mode, on the engine's device otherwise."""
        return torch.device("cpu") if self.client.is_host else self.device

    # -- one stage ------------------------------------------------------------
    def _stage_forward(self, s: int, inputs, cache, active):
        lens0 = cache["len"]
        out, cache = self.model.decode_stage(
            self.stage_params[s], inputs, cache, first=s == 0,
            last=s == self.p - 1)
        # inactive rows must not advance their cache write offset
        cache = dict(cache)
        cache["len"] = torch.where(active, lens0 + 1, lens0)
        return out, cache

    # -- paged bookkeeping (reserving admission) -----------------------------
    def _blocks_for(self, req: Request) -> int:
        total = min(req.prompt_len + req.max_new_tokens,
                    self.ecfg.max_seq_len)
        return self.alloc.blocks_needed(total)

    def _kv_gate(self, req: Request, round_admits: List[Request]) -> bool:
        """Reserving admission: a request enters only when its worst-case
        block demand fits net of every running request's *outstanding*
        worst case (demand minus blocks already owned). Under this gate
        lazy growth can never exhaust the pool, so in-flight microbatches
        never need preemption."""
        reserved = sum(self._blocks_for(r) for r in round_admits)
        for r in self.scheduler.slots:
            # requests admitted earlier THIS round are already slotted (the
            # scheduler installs before gating the next candidate) but own
            # no blocks yet — they are counted once via round_admits above
            if r is None or any(r is a for a in round_admits):
                continue
            reserved += self._blocks_for(r) - len(self.alloc.owned[r.slot])
        return self._blocks_for(req) <= self.alloc.num_free - reserved

    def _on_slot_free(self, slot: int, req: Request) -> None:
        i, local = divmod(slot, self.R)
        self._sp[i].reset_row(local)
        if self._paged:
            self.alloc.release(slot)
            self._slot_len[slot] = 0

    # -- public API ----------------------------------------------------------
    @locked_api
    def submit(self, requests: List[Request]) -> None:
        if self._closed:
            raise RuntimeError("PipelineEngine is closed")
        for r in requests:
            if r.kv_payload is not None:
                raise ValueError(
                    f"request {r.request_id} carries a KVPayload; "
                    "PipelineEngine does not support KV import — "
                    "route migrations to a single-stage Engine")
        if self._paged:
            for r in requests:
                if self._blocks_for(r) > self.pcfg.num_blocks:
                    raise ValueError(
                        f"request {r.request_id} needs {self._blocks_for(r)} "
                        f"KV blocks > pool of {self.pcfg.num_blocks}")
        for r in requests:
            self.scheduler.submit(r)

    @property
    def in_flight(self) -> int:
        """Microbatches with an uncommitted token (activation mid-pipeline
        or sampled tokens awaiting their re-entry commit)."""
        return sum(1 for mb in self._mb
                   if mb.x is not None or mb.ticket is not None
                   or mb.ready is not None)

    @locked_api
    def step(self) -> dict:
        """Advance the pipeline by ONE cycle: every stage serves its
        scheduled microbatch (the last stage first), the re-entering
        microbatch commits its pending token and dispatches the next.
        Returns the commit's StepRecord ({} when no commit landed)."""
        c = self.planner.cycle
        self._cycle_rec = CycleRecord(cycle=c, busy=[None] * self.p)
        rec = {}
        for s in range(self.p - 1, -1, -1):
            i = self.planner.stage_for(c, s)
            mb = self._mb[i]
            if s == 0:
                rec = self._reenter(i) or rec
            elif mb.x is not None and mb.stage_next == s:
                self._run_stage(i, s)
        self.cycle_log.append(self._cycle_rec)
        self._cycle_rec = None
        self.planner.tick()
        return rec

    @locked_api
    def flush(self) -> None:
        """Drain every in-flight microbatch (no new admissions) and retire
        what finished."""
        self._draining = True
        try:
            guard = 2 * (self.M + self.p) + 4
            while self.in_flight and guard:
                self.step()
                guard -= 1
            assert not self.in_flight, "flush failed to drain the pipeline"
        finally:
            self._draining = False
        self.scheduler.retire_finished()

    def run(self, max_steps: int = 50_000) -> List[Request]:
        steps = 0
        while (self.scheduler.has_work or self.in_flight) and \
                steps < max_steps:
            self.step()
            steps += 1
        self.flush()
        return self.scheduler.finished

    def generate(self, requests: List[Request], max_steps: int = 50_000):
        """Stream :class:`~repro_torch.engine.engine.GenerationEvent` items
        at commit time — the same client surface as ``Engine.generate``."""
        yield from generate_stream(self, requests, max_steps)

    def close(self) -> None:
        """Commit every in-flight microbatch, then shut down the sampler
        pool — the same contract as ``Engine.close``: sampled but
        uncommitted tokens are never dropped. Idempotent, and safe on a
        partially constructed engine."""
        if getattr(self, "_closed", False):
            return
        lock = getattr(self, "_api_lock", None)
        if lock is None:
            self._closed = True
            return
        with lock:
            if self._closed:
                return
            self._closed = True
            if getattr(self, "scheduler", None) is not None and \
                    getattr(self, "_mb", None) is not None:
                self.flush()
            client = getattr(self, "client", None)
            if client is not None:
                client.close()

    # -- cycle internals ----------------------------------------------------
    def _reenter(self, i: int) -> Optional[StepRecord]:
        """Microbatch ``i``'s stage-1 re-entry: commit its pending token,
        run scheduling for its slot group, and dispatch the next token."""
        mb = self._mb[i]
        rec = None
        if mb.ticket is not None or mb.ready is not None:
            rec = self._commit(i)
        if self._draining:
            return rec
        plan = self.scheduler.schedule(group=self.planner.group_slots(i))
        if plan.new_requests:
            self._admit_group(i, plan.new_requests)
        active = self._group_activity(i)
        if self._paged and active.any():
            active = self._prepare_paged_group(i, active)
        if not active.any():
            return rec
        group = self.planner.group_slots(i)
        slot_request = [self.scheduler.slots[g] for g in group]
        self.planner.dispatch(i, active, slot_request,
                              self._nonce[i], self._pos[i])
        self._pos[i] += active
        if self._paged:
            self._slot_len[list(group)] += active
        self._run_stage(i, 0, active)
        return rec

    def _group_activity(self, i: int) -> np.ndarray:
        out = np.zeros((self.R,), bool)
        for local, slot in enumerate(self.planner.group_slots(i)):
            s = self.scheduler.slots[slot]
            out[local] = (s is not None
                          and s.state is RequestState.RUNNING
                          and not s.should_stop())
        return out

    def _prepare_paged_group(self, i: int, active: np.ndarray) -> np.ndarray:
        """Grow each decoding row's allocation by one token (infallible
        under the reserving gate) and snapshot the group's block table for
        the whole traversal. Rows at per-sequence capacity stop with
        ``finish_reason="truncated"``."""
        active = active.copy()
        group = list(self.planner.group_slots(i))
        for local, slot in enumerate(group):
            if not active[local]:
                continue
            if int(self._slot_len[slot]) + 1 > self.ecfg.max_seq_len:
                self.scheduler.slots[slot].truncated = True
                active[local] = False
                continue
            self.alloc.ensure(slot, int(self._slot_len[slot]) + 1)
        self._mb[i].block_table = to_device(
            self.alloc.table(self.num_slots)[group], self.device)
        return active

    def _stage_cache(self, s: int, i: int) -> dict:
        cache = dict(self.caches[s][i])
        if self._paged:
            cache["k_pool"] = self.pools[s]["k_pool"]
            cache["v_pool"] = self.pools[s]["v_pool"]
            cache["block_table"] = self._mb[i].block_table
        return cache

    def _store_stage_cache(self, s: int, i: int, cache: dict) -> None:
        if self._paged:
            # the pools were written in place
            for k in ("k_pool", "v_pool", "block_table"):
                cache.pop(k, None)
        self.caches[s][i] = cache

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run_stage(self, i: int, s: int,
                   active: Optional[np.ndarray] = None) -> None:
        mb = self._mb[i]
        rec = self.planner.inflight[i]
        if active is None:
            active = rec.active
        inputs = to_device(self.last_tokens[i], self.device) if s == 0 \
            else mb.x
        t0 = time.perf_counter()
        out, cache = self._stage_forward(s, inputs, self._stage_cache(s, i),
                                         to_device(active, self.device))
        self._sync()                     # the stage's busy time, measured
        t1 = time.perf_counter()
        self._store_stage_cache(s, i, cache)
        if self._cycle_rec is not None:
            self._cycle_rec.busy[s] = t1 - t0
        if self.tracer.enabled:
            # one timeline row per stage: overlap between stage rows and
            # the pool workers' host_sample rows is the paper's Eq. 4 win
            self.tracer.add("stage", t0, t1, name=f"s{s}/mb{i}",
                            track=f"stage{s}", microbatch=i, stage=s,
                            cycle=self.planner.cycle)
        if s == self.p - 1:
            mb.x = None
            mb.stage_next = 0
            self.planner.mark_exit(i)
            self._dispatch_sampling(i, out, rec)
        else:
            mb.x = out
            mb.stage_next = s + 1

    def _dispatch_sampling(self, i: int, logits, rec: _Dispatch) -> None:
        """Hand the exit logits to the decision plane: asynchronously to
        the host sampler pool (disaggregated), or synchronously on the
        device, on the last stage's critical path (baseline, Eq. 4)."""
        mb = self._mb[i]
        sp = self._sp[i]
        if not self.client.is_host:
            t0 = time.perf_counter()
            mb.ready = self.client.sample_sync(
                logits, self.pstate[i], sp.as_params(), sp.bias_array(),
                rec.nonces, rec.positions, rec.exit_cycle, rec.active)
            t1 = time.perf_counter()
            if self._cycle_rec is not None:
                self._cycle_rec.sample = t1 - t0
                if self._cycle_rec.busy[self.p - 1] is not None:
                    self._cycle_rec.busy[self.p - 1] += t1 - t0
            if self.tracer.enabled:
                # Eq. 4 baseline: the draw sits ON the last stage's row,
                # right where it blocks the cycle
                self.tracer.add("host_sample", t0, t1,
                                name=f"sync-sample/mb{i}",
                                track=f"stage{self.p - 1}", microbatch=i)
        else:
            mb.ticket = self.client.submit(
                HostCopy(logits), self.pstate[i], sp.host_params(),
                sp.host_bias(), rec.nonces, rec.positions, rec.exit_cycle,
                rec.active)

    def _commit(self, i: int) -> StepRecord:
        """Commit microbatch ``i``'s sampled token at its re-entry cycle;
        the block on the ticket is the measured sampler-pool stall."""
        mb = self._mb[i]
        rec = self.planner.commit(i)
        if mb.ready is not None:
            res, mb.ready = mb.ready, None
            stall = 0.0
        else:
            t0 = time.perf_counter()
            res = mb.ticket.result()
            t1 = time.perf_counter()
            stall = t1 - t0
            mb.ticket = None
            if self.tracer.enabled:
                self.tracer.add("pool_stall", t0, t1,
                                name=f"stall/mb{i}", microbatch=i,
                                cycle=self.planner.cycle)
        if self._cycle_rec is not None:
            self._cycle_rec.stall = stall
            self._cycle_rec.sampler = res.sampler_time
            self._cycle_rec.transfer = res.transfer_time
        now = time.perf_counter()
        self.scheduler.commit(res.tokens, rec.slot_request, rec.active,
                              now=now)
        if self.tracer.enabled:
            self.tracer.add("commit", now, time.perf_counter(),
                            name=f"commit/mb{i}", microbatch=i,
                            cycle=self.planner.cycle)
        # a placement switch may have moved the histograms' home since
        # this token was dispatched
        self.pstate[i] = _move_state(res.state, self._pstate_home)
        self.last_tokens[i] = np.where(rec.active, res.tokens, 0).astype(
            np.int32)
        out = StepRecord(
            step=rec.dispatch_cycle, batch=int(rec.active.sum()),
            accept_rate=res.accept_rate, alpha_mean=res.alpha_mean,
            fallback_rate=res.fallback_rate, stall_ms=stall * 1e3,
            sampler_ms=res.sampler_time * 1e3,
            transfer_ms=res.transfer_time * 1e3,
            queue_depth=float(len(self.scheduler.waiting)),
            queue_delay_ms=self._queue_delay_ms(),
            bubble_frac=self._last_bubble())
        self.stats_log.append(out)
        if self._dpc is not None:
            act = self._dpc.observe_record(out)
            if act:
                self._apply_action(act, out, i)
        self._metrics.observe_step(out)
        return out

    def _apply_action(self, act, out: StepRecord, i: int) -> None:
        """Apply a controller action. The client joins every outstanding
        ticket before it re-routes or recycles the pool; each in-flight
        microbatch still commits the result of the placement it was
        dispatched under, and its histograms move to the new home at
        that commit. The histograms of the others move now."""
        if act.samplers is not None:
            self.client.resize_pool(act.samplers)
            out.samplers = act.samplers
            self._metrics.pool_workers.set(float(act.samplers))
        if act.sampler_mode is not None and \
                self.client.set_mode(act.sampler_mode):
            home = self._pstate_home
            self.pstate = [_move_state(ps, home) for ps in self.pstate]
            out.sampler_mode = act.sampler_mode
            self._metrics.mode_host.set(1.0 if self.client.is_host else 0.0)
        self._metrics.decisions.inc()
        if self.tracer.enabled:
            self.tracer.instant(
                "decision", name=f"decision/mb{i}",
                cycle=self.planner.cycle, hot_size=act.hot_size,
                samplers=act.samplers, sampler_mode=act.sampler_mode)

    def _queue_delay_ms(self) -> float:
        """Oldest waiting request's queueing delay; NaN when arrivals carry
        no wall-clock stamps."""
        if not self.scheduler.waiting:
            return 0.0
        now = time.perf_counter()
        ds = [now - r.arrival_time
              for r in self.scheduler.waiting if r.arrival_time]
        return max(ds) * 1e3 if ds else float("nan")

    def _last_bubble(self) -> float:
        """Bubble fraction of the most recent FULL cycle (every stage
        timed), Eq. 4's ``Σ_s (C − busy_s) / (p·C)``; NaN during fill.
        Walks the bounded ring newest-first and gives up after 2·M
        cycles."""
        for n, r in enumerate(reversed(self.cycle_log)):
            if n >= 2 * self.M:
                break
            if r.full:
                busy = np.asarray(r.busy, float)
                busy[0] += r.stall
                C = float(busy.max())
                if C > 0:
                    return float((C - busy).sum() / (self.p * C))
        return float("nan")

    # -- admission -----------------------------------------------------------
    def _prefill_impl(self, params, tokens, true_lens):
        """Monolithic prefill over the FULL stack (a prompt traverses all
        stages in one program, which composes like the per-stage decode);
        rows are stage-split on insert."""
        P = tokens.shape[0]
        cache = self.model.init_cache(P, self.ecfg.max_seq_len,
                                      device=self.device)
        logits, cache = self.model.prefill(params, {"tokens": tokens}, cache,
                                           true_lens=true_lens)
        pstate = pen.init_state(P, self.cfg.vocab_size, tokens, true_lens)
        return logits, cache, pstate

    def _admit_group(self, i: int, new_requests: List[Request]) -> None:
        """Prefill newly admitted requests for microbatch ``i`` and install
        the rows into its per-stage caches. The admission math is shared
        with ``Engine._admit`` (``engine.prefill_new_rows``), so the
        engines' identity cannot drift; the first draw runs on the device
        and the rows' histograms then cross to their home."""
        t_pf = time.perf_counter()
        if self.tracer.enabled:
            for r in new_requests:
                if r.arrival_time:
                    self.tracer.add("queue_wait", r.arrival_time, t_pf,
                                    name=f"wait#{r.request_id}",
                                    request_id=int(r.request_id),
                                    microbatch=i)
        first, rows_cache, rows_pstate, lens, bases, rids = \
            prefill_new_rows(self, new_requests, self.planner.cycle)
        base_slot = i * self.R
        locals_ = np.asarray([r.slot - base_slot for r in new_requests],
                             np.int64)
        if self._paged:
            self._paged_insert_group(i, new_requests, rows_cache, lens,
                                     locals_)
        else:
            slots = to_device(locals_, self.device)
            for s, (lo, hi) in enumerate(self.bounds):
                _insert_rows(self.caches[s][i],
                             slice_stage_cache(rows_cache, lo, hi), slots)
        home = self._pstate_home
        hslots = to_device(locals_, home)
        for dst, src in zip(self.pstate[i], rows_pstate):
            dst[hslots] = src.to(home)
        now = time.perf_counter()
        first_np = first.cpu().numpy()   # blocks on the prefill
        if self.tracer.enabled:
            self.tracer.add("prefill", t_pf, time.perf_counter(),
                            name=f"prefill x{len(new_requests)}/mb{i}",
                            rows=len(new_requests), microbatch=i)
        for k, r in enumerate(new_requests):
            local = int(locals_[k])
            self._sp[i].set_row(local, r.sampling)
            self._nonce[i][local] = rids[k]
            self._pos[i][local] = int(bases[k]) + 1
            self.last_tokens[i][local] = int(first_np[k])
            r.record_token(int(first_np[k]), now)

    def _paged_insert_group(self, i: int, new_requests: List[Request],
                            rows_cache, lens: np.ndarray,
                            locals_: np.ndarray) -> None:
        """Scatter freshly prefilled rows into every stage's pool slice, in
        place (block ids are stage-invariant, so one destination map
        serves all stages)."""
        for k, r in enumerate(new_requests):
            self.alloc.release(r.slot)         # stale claims (defensive)
            self.alloc.ensure(r.slot, int(lens[k]))
            self._slot_len[r.slot] = int(lens[k])
        d = self.device
        row_bt = to_device(self.alloc.table(self.num_slots)[
            [r.slot for r in new_requests]], d)
        Sc = rows_cache["k"].shape[2]
        true_lens = to_device(lens, d)
        valid = torch.arange(Sc, device=d)[None, :] < true_lens[:, None]
        flat = flat_block_indices(row_bt, torch.zeros_like(true_lens), valid,
                                  self.pcfg.block_size, self.pcfg.num_blocks)
        slots = to_device(locals_, d)
        for s, (lo, hi) in enumerate(self.bounds):
            scatter_block_kv(self.pools[s]["k_pool"], rows_cache["k"][lo:hi],
                             flat)
            scatter_block_kv(self.pools[s]["v_pool"], rows_cache["v"][lo:hi],
                             flat)
            self.caches[s][i]["len"][slots] = true_lens

    # -- observability -------------------------------------------------------
    def pipeline_report(self) -> dict:
        """The cycle log as the paper's Eq. 4 quantities for ``p`` separate
        devices, from the measured stage times: steady-state cycle time
        ``C = max_s busy_s`` (baseline: the last stage's busy includes the
        synchronous draw; the stage-1 slot includes any sampler-pool
        stall), per-stage utilization ``busy_s / C``, and the bubble
        fraction ``Σ_s (C − busy_s) / (p·C)``. Only *full* cycles — every
        stage served a microbatch — count (the fill/drain ramp is
        excluded). On one device the stages run one after another, so a
        cycle there takes about ``Σ_s busy_s`` plus the stall, not ``C``."""
        full = [r for r in self.cycle_log if r.full]
        if not full:
            return {"cycles": 0, "bubble_frac": 0.0,
                    "stage_util": [0.0] * self.p, "mean_cycle_ms": 0.0,
                    "stall_ms_mean": 0.0, "sample_ms_mean": 0.0,
                    "sampler_ms_mean": 0.0, "transfer_ms_mean": 0.0}
        busy = np.zeros((len(full), self.p))
        for k, r in enumerate(full):
            busy[k] = r.busy
            busy[k][0] += r.stall
        C = busy.max(axis=1)
        bubble = (C[:, None] - busy).sum() / (self.p * C.sum())
        samplers = [r.sampler for r in full if r.sampler is not None]
        transfers = [r.transfer for r in full if r.transfer is not None]
        return {
            "cycles": len(full),
            "bubble_frac": float(bubble),
            "stage_util": [float(u) for u in busy.sum(0) / C.sum()],
            "mean_cycle_ms": float(C.mean() * 1e3),
            "stall_ms_mean": float(np.mean([r.stall for r in full]) * 1e3),
            "sample_ms_mean": float(np.mean([r.sample for r in full]) * 1e3),
            # sampler_ms is pure CPU sampling on the workers' critical
            # path; transfer_ms their wait for the logits' copy
            "sampler_ms_mean": float(np.mean(samplers) * 1e3) if samplers
            else 0.0,
            "transfer_ms_mean": float(np.mean(transfers) * 1e3) if transfers
            else 0.0,
        }
