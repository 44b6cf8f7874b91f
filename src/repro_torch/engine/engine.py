"""The serving engine: continuous batching + the SIMPLE decision plane.

The engine's iteration (paper §4.2, DESIGN.md §2):

  ⓪ scheduler.schedule()            — retire / admit / emit scheduling output
  ① prefill newly admitted requests — monolithic rows inserted into slots,
                                      or one prompt chunk per mid-prefill row
  ②③ decode forward                 — logits (B, V) f32
  ④⑤ decision plane                 — penalties + sampling on the device
  ⑥ scheduler.commit()              — tokens back into request state

**Overlapped mode (default).** Steps ②–⑤ only enqueue work on the
device's stream; iteration N's tokens feed iteration N+1's forward as a
device tensor. At dispatch the engine starts a ``non_blocking`` copy of
the step's tokens into pinned host memory and records a CUDA event; the
drain — one step later, after iteration N+1 has been enqueued — waits on
that event only. A plain ``tokens.cpu()`` at the drain would queue behind
N+1's kernels and serialise the loop. The cost is the reference's
one-step commit lag: a request whose stop condition is in flight gets one
speculative decode whose token is dropped at commit. With
``overlap=False`` every iteration drains immediately.

**CUDA graphs** (``engine/step_graph.py``). On a card with no mesh,
steps ②③ (the forward graph) and ④⑤ (the decide graph) are each
captured once, at their second use, and replayed: one launch of the host
instead of thousands. The graphs read and write the engine's own cache
leaves and histograms; each step's inputs (active mask, uniforms, last
tokens) are copied into their buffers on the stream first. Anywhere else
the step runs eagerly, as it always did.

Determinism: uniforms are keyed on (request-id, output position), drawn
on the host bit-equal to the reference's ``jax.random`` stream, so each
request's tokens are the same in overlapped and sequential mode and do
not depend on slot placement or admission timing. Exception: the
``gumbel`` backend keys its fast path on the global iteration index, so
its streams are reproducible run to run but depend on the schedule.

**Paged KV** (``cache="paged"``): a block pool replaces the per-slot
cache. The scheduler admits by free blocks (``ceil((prompt+max_new) /
block_size)``), blocks are allocated as sequences grow, and pool
exhaustion preempts the most recently admitted request (blocks freed,
re-queued at the front, recompute-on-resume). Each paged decode step
uploads the host allocator's block table with a ``non_blocking`` copy;
nothing is read back. **Chunked prefill** (``prompt_chunk > 0``): long
prompts are prefilled one (B, C) chunk per iteration beside the decode
rows; a row finishing its prompt samples its first token in the chunk
program, and that token reaches the host through the pending queue, like
a decode step's.

**Host sampler mode** (``sampler_mode="host"``, DESIGN.md §13). The
engine reaches the decision plane through a
:class:`~repro_torch.engine.decision_client.DecisionPlaneClient`: device
mode keeps the decision inside the decode step (everything above); host
mode enqueues a forward-only step, starts a ``non_blocking`` copy of its
logits into pinned memory behind it (a CUDA event marks the copy's end)
and hands that copy, with host snapshots of the sampling rows, to the
client's pool of CPU workers. The workers wait on the event, sample
sequence-parallel row shards through a CPU ``DecisionPlane`` and return
tokens and updated histograms; the engine resolves the ticket at the top
of the next step (before admissions overwrite any slot's rows), uploads
the tokens with a ``non_blocking`` copy and commits one step behind,
exactly like the overlapped device loop. In host mode the (B, V)
histograms live on the host; the prefill and chunk draws still run on the
device, and their rows cross at admission, which waits for the prefill
anyway. A placement switch moves the histograms once. On the CPU streams
are bit-identical to device mode in every engine mode
(``tests/test_torch_host.py``).

``sampler_mode="adaptive"`` starts on the device and lets a
:class:`~repro_torch.core.autotune.DecisionPlaneController` switch
placement and resize the pool online from the engine's own step records;
``autotune=True`` with ``hot_counts`` tracks the SHVS hot-set size H*
(:class:`~repro_torch.core.autotune.HotSizeController`). A
:class:`~repro_torch.obs.Telemetry` bundle (``telemetry=``) carries the
flight-recorder tracer (off by default) and the metrics registry.

**KV migration** (DESIGN.md §18): :meth:`Engine.export_request` quiesces
one running request at a commit boundary (``flush``) and detaches it as a
:class:`~repro_torch.engine.migration.KVPayload` (its K/V rows, histogram
rows from wherever they live, sampling contract and RNG position);
:meth:`Engine.import_request` queues a payload like any request, and
admission installs it into its slot instead of prefilling. The importer
may use the other cache layout or the other sampler placement: the
decode program cannot tell the request moved, so its stream is the
never-migrated one (``tests/test_torch_migration.py``).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig, SamplingConfig, SHVSConfig
from repro_torch.core import penalties as pen
from repro_torch.core.decision_plane import DecisionPlane
from repro_torch.core.host_sampler import PoolResult, SampleTicket
from repro_torch.core.sampling import SamplingParams
from repro_torch.device import HostCopy, resolve_device, to_device
from repro_torch.engine.decision_client import (DecisionPlaneClient,
                                                canonical_sampler_mode)
from repro_torch.engine.migration import KVPayload, stamp_export
from repro_torch.engine.paged_cache import (BlockAllocator, PagedCacheConfig,
                                            gather_slot_kv, init_paged_cache,
                                            scatter_slot_kv)
from repro_torch.engine.request import Request, RequestState
from repro_torch.engine.scheduler import ChunkTask, Scheduler
from repro_torch.engine.step_graph import StepGraph, bind, capture
from repro_torch.models import dist
from repro_torch.models.attention import flat_block_indices, scatter_block_kv
from repro_torch.models.model import Model
from repro_torch.models.transformer import cache_bytes
from repro_torch.obs import EngineMetrics, StepRecord, Telemetry
from repro_torch.obs import tracer as obs_tracer


@dataclass
class EngineConfig:
    max_batch: int = 8               # batch slots (B)
    max_seq_len: int = 512           # cache capacity per slot
    algorithm: str = "shvs"          # decision-plane algorithm
    shvs: SHVSConfig = SHVSConfig()
    # decision-plane placement on a mesh (the identity without one):
    # "sequence_parallel" | "vocab_gather" | "hierarchical"
    sampling_parallelism: str = "sequence_parallel"
    k_cap: int = 256
    seed: int = 0
    prompt_bucket: int = 32          # prompts padded to multiples of this
    overlap: bool = True             # double-buffered iteration loop (§2)
    prompt_chunk: int = 0            # >0: chunked prefill width
    priority_admission: bool = True  # single-chunk prompts admitted first
    max_admission_wait: int = 64     # aging bound for priority admission
    cache: str = "contiguous"        # KV layout: "contiguous" | "paged"
    block_size: int = 16             # paged: tokens per KV block
    num_blocks: int = 0              # paged pool size; 0 = memory-equal to
    #                                  the contiguous cache (B * S / bs)
    sampler_mode: str = "device"     # decision plane placement (§13/§15):
    #                                  "device" (inside the decode step) |
    #                                  "host" (CPU sampler pool, committed
    #                                  one step behind) | "adaptive" (a
    #                                  DecisionPlaneController switches
    #                                  placement and resizes the pool online)
    samplers: int = 2                # host-mode sampler pool workers
    pool_algorithm: Optional[str] = None   # pool-level backend override:
    #                                  host-mode workers draw with this
    #                                  registered backend while the engine
    #                                  plane keeps ``algorithm`` (§14)
    stats_window: int = 4096         # stats_log ring size


def _bucket(n: int, mult: int) -> int:
    return max(mult, ((n + mult - 1) // mult) * mult)


def locked_api(fn):
    """Serialize a public engine method on the instance's ``_api_lock``
    (reentrant, so locked methods may nest). It serializes only the host
    orchestration; the device work stays asynchronous underneath."""
    import functools

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self._api_lock:
            return fn(self, *args, **kwargs)
    return wrapper


def traced_api(fn):
    """Install the engine's tracer, when it is enabled, as this thread's
    ``obs.tracer.current()`` for the call, so the model's forward records
    its spans (``moe_route``) into it."""
    import functools

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        if not self.tracer.enabled:
            return fn(self, *args, **kwargs)
        with obs_tracer.use(self.tracer):
            return fn(self, *args, **kwargs)
    return wrapper


@dataclass(frozen=True)
class GenerationEvent:
    """One streamed output item from :meth:`Engine.generate`.

    ``token`` is ``None`` only on a terminal event that carries a
    ``finish_reason`` without a new token. ``finish_reason`` is set on
    each request's final event (``eos | length | stop | truncated``).
    """

    request_id: int
    token: Optional[int]
    finish_reason: Optional[str] = None


class StreamCursor:
    """Incremental view of one request's committed tokens as
    :class:`GenerationEvent` items."""

    def __init__(self, request: Request):
        self.request = request
        self.emitted = 0
        self.closed = False

    def drain(self) -> Iterator[GenerationEvent]:
        """Yield every committed-but-undelivered token (the final one
        carrying ``finish_reason``); a request that finished without a
        fresh token yields a terminal ``token=None`` event."""
        r = self.request
        if self.closed:
            return
        while self.emitted < len(r.output):
            tok = r.output[self.emitted]
            self.emitted += 1
            fin = r.finish_reason if self.emitted == len(r.output) else None
            if fin is not None:
                self.closed = True
            yield GenerationEvent(r.request_id, tok, fin)
        if not self.closed and r.finish_reason is not None:
            self.closed = True
            yield GenerationEvent(r.request_id, None, r.finish_reason)


def generate_stream(eng, requests: List[Request], max_steps: int = 10_000):
    """Submit ``requests``, drive ``eng.step()`` and yield
    :class:`GenerationEvent` items as tokens **commit** on the host.
    ``eng`` needs ``submit`` / ``step`` / ``flush`` / ``in_flight`` /
    ``scheduler.has_work``."""
    requests = list(requests)
    if not requests:
        return
    eng.submit(requests)
    cursors = [StreamCursor(r) for r in requests]

    def drain():
        for c in cursors:
            yield from c.drain()

    steps = 0
    try:
        while not all(c.closed for c in cursors) and steps < max_steps and \
                (eng.scheduler.has_work or eng.in_flight):
            eng.step()
            steps += 1
            yield from drain()
    except GeneratorExit:
        # the caller abandoned the iterator: commit everything in flight
        eng.flush()
        raise
    eng.flush()
    yield from drain()
    if not all(c.closed for c in cursors):
        open_ids = [c.request.request_id for c in cursors if not c.closed]
        raise RuntimeError(
            f"generate() hit max_steps={max_steps} with requests still "
            f"unfinished: {open_ids}")


def prefill_new_rows(eng, new_requests: List[Request], step_idx: int):
    """Admission math: bucket and pad the requests' contexts, run the
    monolithic prefill, rebuild resumed rows' prompt/output histogram split
    (presence/frequency penalties read C_o, Eq. 5) and sample each row's
    first token at its resume position (``len(output)``, 0 for fresh
    rows). A resumed request (re-queued by preemption) re-prefills
    prompt + output.

    Returns ``(first, rows_cache, rows_pstate, lens, bases, rids)`` —
    ``first`` is the (P,) device token tensor."""
    P = len(new_requests)
    ctxs = [r.context_tokens() if r.output else r.prompt
            for r in new_requests]
    maxlen = max(len(c) for c in ctxs)
    Sp = min(_bucket(maxlen, eng.ecfg.prompt_bucket), eng.ecfg.max_seq_len)
    toks = np.zeros((P, Sp), np.int32)
    lens = np.zeros((P,), np.int32)
    bases = np.zeros((P,), np.int32)   # next output position per row
    for i, (r, c) in enumerate(zip(new_requests, ctxs)):
        c = c[-Sp:]
        toks[i, :len(c)] = c
        lens[i] = len(c)
        bases[i] = len(r.output)
    dev = eng.device
    logits, rows_cache, rows_pstate = eng._prefill_impl(
        eng.params, to_device(toks, dev), to_device(lens, dev))
    rids = np.array([r.request_id for r in new_requests], np.uint32)
    # resumed rows: the prefill counted prompt+output as one sequence, but
    # the penalty state keeps the prompt/output split
    V = eng.cfg.vocab_size
    for i, r in enumerate(new_requests):
        if not r.output:
            continue
        rows_pstate.prompt_counts[i] = pen.histogram(
            to_device(np.asarray(r.prompt, np.int32)[None], dev), V)[0]
        rows_pstate.output_counts[i] = pen.histogram(
            to_device(np.asarray(r.output, np.int32)[None], dev), V)[0]
    sp_rows = SlotParams(P, V, dev)
    for i, r in enumerate(new_requests):
        sp_rows.set_row(i, r.sampling)
    with eng.tracer.span("device_sample", device=dev, program="prefill",
                         rows=P, step=step_idx):
        first, rows_pstate, _ = eng.decision.step(
            logits, rows_pstate, sp_rows.as_params(), step_idx,
            rng_tags=(rids, bases), logit_bias=sp_rows.bias_array())
    return first, rows_cache, rows_pstate, lens, bases, rids


def _move_state(state: pen.PenaltyState, device) -> pen.PenaltyState:
    """The histograms on ``device`` (a no-op where they already are). A
    copy to the host waits for the stream; one to a card does not."""
    return pen.PenaltyState(*(t.to(device, non_blocking=device.type != "cpu")
                              for t in state))


@dataclass
class _Pending:
    """One dispatched-but-uncommitted iteration: ``kind="decode"`` a decode
    step (tokens and stats in ``fetch``), ``kind="host"`` a decode step
    whose decision runs in the sampler pool (``ticket``; ``res`` once
    resolved, ``stall`` the engine's block on it), ``kind="first"`` the
    first tokens of rows that finished their prompt in a chunk program
    (``finishers``: (slot, request))."""

    fetch: Optional[HostCopy] = None
    kind: str = "decode"
    step: int = -1
    active: Optional[np.ndarray] = None         # (B,) bool snapshot
    slot_request: List[Optional[Request]] = field(default_factory=list)
    finishers: List[Tuple[int, Request]] = field(default_factory=list)
    ticket: Optional[SampleTicket] = None       # host mode: pending shards
    res: Optional[PoolResult] = None            # host mode: resolved result
    stall: float = 0.0                          # host mode: block on ticket
    t_dispatch: float = 0.0                     # perf_counter at dispatch


def refuse_encdec(cfg: ModelConfig) -> None:
    """The engines serve no encoder-decoder model: their prefill passes
    ``{"tokens"}`` only, as the reference's does, so the encoder never
    sees frames (the reference's engine fails at its first prefill)."""
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: the engines do not serve encoder-decoder models "
            "(prefill never receives the encoder frames; ROADMAP Fault 7). "
            "Model.prefill(params, {'tokens', 'frames'}, cache) serves "
            "them directly")


class Engine:
    """Serving engine over one device. ``device`` defaults to "cuda" and
    must match where ``params`` live; CUDA without a card raises.

    Optional online hot-size autotuning (paper §9 future work (i)): pass
    ``hot_counts`` (a token-frequency vector) and ``autotune=True`` — the
    engine feeds the measured hot mass into
    :class:`~repro_torch.core.autotune.HotSizeController` and rebuilds the
    hot set when H* moves."""

    def __init__(self, model_cfg: ModelConfig, params,
                 engine_cfg: EngineConfig, hot_set=None, hot_counts=None,
                 autotune: bool = False, device="cuda",
                 telemetry: Optional[Telemetry] = None):
        self._api_lock = threading.RLock()
        self._closed = False
        refuse_encdec(model_cfg)
        self.device = resolve_device(device)
        self.cfg = model_cfg
        self.ecfg = engine_cfg
        self.model = Model(model_cfg)
        self.params = params
        B, S = engine_cfg.max_batch, engine_cfg.max_seq_len
        # chunked prefill and the paged cache are gated to full-causal
        # dense/MoE decoders (the chunk and the gathered block view reuse
        # the cached attention masks); a recurrent family prefills whole
        chunkable = (model_cfg.family in ("dense", "moe")
                     and not model_cfg.is_encdec
                     and not model_cfg.sliding_window)
        chunk = engine_cfg.prompt_chunk if (
            engine_cfg.prompt_chunk > 0 and chunkable) else 0
        # a chunk's slab write needs lens + C <= max_seq_len even for the
        # last partial chunk, i.e. C <= max_seq_len // 2
        assert chunk <= S // 2, (
            f"prompt_chunk={chunk} must be <= max_seq_len//2 ({S // 2})")
        assert engine_cfg.cache in ("contiguous", "paged"), engine_cfg.cache
        self._paged = engine_cfg.cache == "paged"
        kv_gate = None
        if self._paged:
            assert chunkable, \
                "cache='paged': full-causal dense/moe decoders only"
            bs = engine_cfg.block_size
            assert S % bs == 0, (
                f"max_seq_len={S} must be a multiple of block_size={bs} so "
                "the gathered block view is shaped exactly like the "
                "contiguous cache")
            mb = S // bs
            self.pcfg = PagedCacheConfig(
                block_size=bs, num_blocks=engine_cfg.num_blocks or B * mb,
                max_blocks_per_seq=mb)
            self.alloc = BlockAllocator(self.pcfg, B)
            # host mirror of each slot's dispatch-time cache length (the
            # device `len` is in flight under the overlapped loop)
            self._slot_len = np.zeros((B,), np.int64)
            kv_gate = self._kv_gate
        self.scheduler = Scheduler(
            B, prompt_chunk=chunk,
            priority_admission=engine_cfg.priority_admission,
            max_admission_wait=engine_cfg.max_admission_wait,
            max_prompt=max(chunk, S - chunk), kv_gate=kv_gate,
            on_free=self._on_slot_free)
        self.decision = DecisionPlane(
            model_cfg.vocab_size, algorithm=engine_cfg.algorithm,
            shvs=engine_cfg.shvs, hot_set=hot_set,
            sampling_parallelism=engine_cfg.sampling_parallelism,
            k_cap=min(engine_cfg.k_cap, model_cfg.vocab_size),
            seed=engine_cfg.seed, device=self.device)
        # "adaptive" (§15) starts on the device — the better placement at
        # light load, where there is no sampling work to overlap — and lets
        # the controller disaggregate online under queue pressure
        self._adaptive = engine_cfg.sampler_mode == "adaptive"
        # telemetry (§17): a flight-recorder tracer (off by default) plus
        # the metrics registry; the tracer rides into the client so pool
        # workers record their fetch/sample spans on the same clock
        self.obs = telemetry if telemetry is not None else Telemetry()
        self.tracer = self.obs.tracer
        self._metrics = EngineMetrics(self.obs.metrics)
        self.client = DecisionPlaneClient(
            self.decision,
            "device" if self._adaptive else engine_cfg.sampler_mode,
            engine_cfg.samplers, pool_algorithm=engine_cfg.pool_algorithm,
            tracer=self.tracer)
        self._host = self.client.is_host
        self._metrics.mode_host.set(1.0 if self._host else 0.0)
        self._metrics.pool_workers.set(float(engine_cfg.samplers))
        self.cache = (init_paged_cache(model_cfg, B, self.pcfg,
                                       device=self.device) if self._paged
                      else self.model.init_cache(B, S, device=self.device))
        self._metrics.cache_bytes(*cache_bytes(self.cache))
        self.pstate = _move_state(self.decision.init_state(B),
                                  self._pstate_home)
        self.last_tokens = torch.zeros((B,), dtype=torch.int32,
                                       device=self.device)
        self._sp = SlotParams(B, model_cfg.vocab_size, self.device)
        # per-slot RNG tags: request nonce + next output position (host)
        self._nonce = np.zeros((B,), np.uint32)
        self._pos = np.zeros((B,), np.int32)
        self._pending: List[_Pending] = []
        # the decode step as CUDA graphs (step_graph.py), on a card: each
        # variant's graph (None once it has run eagerly and is to be
        # captured at its next use), the per-step inputs' device buffers
        # and the capture stream
        self._graph_device = self.device.type == "cuda"
        self._graphs: dict = {}
        self._static: Optional[dict] = None
        self._capture_stream = None
        self.migrations_in = 0
        self.migrations_out = 0
        self.stats_log: Deque[StepRecord] = deque(
            maxlen=engine_cfg.stats_window)
        self._metrics.free_blocks.set(
            float(self.alloc.num_free) if self._paged else -1.0)
        self._hot_counts = hot_counts
        self._controller = None
        hot = None
        if autotune and engine_cfg.algorithm in ("shvs", "fused"):
            from repro_torch.core.autotune import HotSizeController
            if hot_counts is None:
                raise ValueError("autotune needs hot_counts")
            hot = HotSizeController(
                vocab_size=model_cfg.vocab_size,
                h_current=int(self.decision.hot_set.indices.numel()))
        self._dpc = None
        if self._adaptive:
            # global decision-plane controller (§15): placement + pool
            # sizing from the per-step stat streams, H* as a sub-policy
            from repro_torch.core.autotune import DecisionPlaneController
            self._dpc = DecisionPlaneController(
                mode=self.client.mode, samplers=engine_cfg.samplers,
                queue_high=float(engine_cfg.max_batch), hot=hot)
        else:
            self._controller = hot

    @property
    def _pstate_home(self) -> torch.device:
        """Where the (B, V) histograms live: with the host pool in host
        mode, on the engine's device otherwise."""
        return torch.device("cpu") if self._host else self.device

    # -- device programs ------------------------------------------------------
    def _forward_impl(self, params, cache, last_tokens, active):
        """The decode forward without the decision: returns the step's
        logits (host mode hands them to the sampler pool)."""
        lens0 = cache["len"]
        logits, cache = self.model.decode_step(params, last_tokens, cache)
        # inactive rows (retired-but-uncommitted or empty slots) must not
        # advance their cache write offset
        cache = dict(cache)
        cache["len"] = torch.where(active, lens0 + 1, lens0)
        return logits, cache

    def _decide_impl(self, logits, pstate, sparams, bias, u, step, active):
        """The decode step's decision on the device, from its logits and
        the (B, 3) uniforms already on the device: (tokens, inactive rows
        0; the new histograms; the stats as one (3,) f32 tensor)."""
        tokens, pstate, stats = self.decision.step(
            logits, pstate, sparams, step, active=active, logit_bias=bias,
            uniforms=u)
        return (torch.where(active, tokens, 0), pstate,
                torch.stack([s.float() for s in stats]))

    def _prefill_impl(self, params, tokens, true_lens):
        """Prefill a fresh batch (P rows); returns (last-position logits,
        cache rows, penalty-state rows)."""
        P = tokens.shape[0]
        cache = self.model.init_cache(P, self.ecfg.max_seq_len,
                                      device=self.device)
        logits, cache = self.model.prefill(params, {"tokens": tokens}, cache,
                                           true_lens=true_lens)
        pstate = pen.init_state(P, self.cfg.vocab_size, tokens, true_lens)
        return logits, cache, pstate

    def _chunk_impl(self, params, cache, pstate, toks, counts, mask, finish,
                    sparams, bias, nonces, last_tokens, step):
        """One prompt chunk for every mid-prefill row; rows finishing their
        prompt sample their first token (position 0) in the same program."""
        logits, cache = self.model.prefill_chunk(params, toks, cache, counts,
                                                 mask)
        with self.tracer.span("device_sample", device=self.device,
                              program="chunk", rows=logits.shape[0],
                              step=step):
            tokens, pstate, _ = self.decision.step(
                logits, pstate, sparams, step, active=finish,
                rng_tags=(nonces, np.zeros(nonces.shape, np.int32)),
                logit_bias=bias)
        tokens = torch.where(finish, tokens, 0)
        last_tokens = torch.where(finish, tokens, last_tokens)
        return tokens, last_tokens, cache, pstate

    # -- paged KV bookkeeping -------------------------------------------------
    def _blocks_for(self, req: Request) -> int:
        """Worst-case block demand of a request — the admission unit.
        Invariant across preemption/resume: prompt + output + remaining
        always sums to prompt_len + max_new_tokens."""
        total = min(req.prompt_len + req.max_new_tokens,
                    self.ecfg.max_seq_len)
        return self.alloc.blocks_needed(total)

    def _kv_gate(self, req: Request, round_admits: List[Request]) -> bool:
        """Block-based admission: a request enters only when its worst-case
        blocks are free, net of the worst-case demand of requests admitted
        earlier this round."""
        reserved = sum(self._blocks_for(r) for r in round_admits)
        return self._blocks_for(req) <= self.alloc.num_free - reserved

    def _on_slot_free(self, slot: int, req: Request) -> None:
        """A slot gave up its claim (retire or preemption): reset its
        sampling-contract row so nothing stale is dispatched for the slot's
        next occupant, and release its KV blocks (paged mode)."""
        self._sp.reset_row(slot)
        if self._paged:
            self.alloc.release(slot)
            self._slot_len[slot] = 0

    def _push_block_table(self) -> None:
        """Upload the host allocator's block table (a non_blocking copy
        from pageable memory: it never waits on the stream)."""
        cache = dict(self.cache)
        cache["block_table"] = to_device(
            self.alloc.table(self.ecfg.max_batch), self.device)
        self.cache = cache

    def _pick_victim(self) -> Optional[Request]:
        """Preemption victim: the most recently admitted slotted request
        (ties broken by slot for determinism)."""
        cands = [r for r in self.scheduler.slots if r is not None and
                 r.state in (RequestState.RUNNING, RequestState.PREFILLING)]
        if len(cands) <= 1:
            return None
        return max(cands, key=lambda r: (r.admit_step, r.slot))

    def _ensure_blocks(self, slot: int, target_len: int, plan=None) -> bool:
        """Grow ``slot``'s allocation to cover ``target_len`` tokens,
        preempting under pool pressure. Returns False iff the slot's own
        request was evicted (it frees itself and skips this iteration)."""
        if self.alloc.blocks_needed(target_len) > \
                self.pcfg.max_blocks_per_seq:
            raise RuntimeError(
                f"sequence of {target_len} tokens exceeds cache capacity "
                f"({self.pcfg.max_blocks_per_seq} blocks per sequence)")
        owner = self.scheduler.slots[slot]
        while True:
            try:
                self.alloc.ensure(slot, target_len)
                return True
            except RuntimeError:
                pass
            # commit in-flight iterations and retire what finished: their
            # released blocks may already cover the demand
            self.flush()
            if self.scheduler.slots[slot] is not owner:
                return False       # the flush retired this very row
            try:
                self.alloc.ensure(slot, target_len)
                return True
            except RuntimeError:
                pass
            victim = self._pick_victim()
            if victim is None:
                raise RuntimeError(
                    "paged KV pool cannot hold a single sequence "
                    f"(need {self.alloc.blocks_needed(target_len)} blocks, "
                    f"pool={self.pcfg.num_blocks})")
            vslot = victim.slot
            self.scheduler.preempt(victim)
            if plan is not None:
                plan.active_slots[vslot] = False
                plan.slot_request[vslot] = None
            if vslot == slot:
                return False

    def _decode_activity(self) -> np.ndarray:
        return np.array(
            [s is not None and s.state is RequestState.RUNNING
             and not s.should_stop() for s in self.scheduler.slots])

    def _prepare_paged_decode(self, plan) -> np.ndarray:
        """Ensure every decoding row has a block for its next token,
        preempting the lowest-priority requests on exhaustion; returns the
        refreshed activity mask (a fixed point: ensuring one row may evict
        another already-checked one). A row whose next token would exceed
        the per-sequence capacity stops (``Request.truncated``)."""
        while True:
            active = self._decode_activity()
            aborted = False
            for b in np.flatnonzero(active):
                s = self.scheduler.slots[b]
                if s is None or s.state is not RequestState.RUNNING:
                    aborted = True      # evicted mid-sweep
                    break
                if int(self._slot_len[b]) + 1 > self.ecfg.max_seq_len:
                    s.truncated = True  # capacity stop, not pool pressure
                    aborted = True
                    break
                if not self._ensure_blocks(
                        int(b), int(self._slot_len[b]) + 1, plan):
                    aborted = True      # a row was evicted mid-sweep
                    break
            if not aborted and np.array_equal(self._decode_activity(),
                                              active):
                return active

    # -- public API -----------------------------------------------------------
    @locked_api
    def submit(self, requests: List[Request]) -> None:
        if self._closed:
            raise RuntimeError("Engine is closed")
        if self._paged:
            # validate the whole batch before enqueueing any of it: the
            # gate would skip a request the pool can never cover on every
            # round (silent starvation)
            for r in requests:
                if self._blocks_for(r) > self.pcfg.num_blocks:
                    raise ValueError(
                        f"request {r.request_id} needs {self._blocks_for(r)} "
                        f"KV blocks (prompt {r.prompt_len} + max_new "
                        f"{r.max_new_tokens}) > pool of "
                        f"{self.pcfg.num_blocks}")
        for r in requests:
            self.scheduler.submit(r)

    @property
    def in_flight(self) -> int:
        """Dispatched-but-uncommitted iterations (0 or 1 in overlap mode)."""
        return len(self._pending)

    @locked_api
    @traced_api
    def step(self):
        """One engine iteration. Returns the StepRecord committed this call
        (lagged by one step in overlapped mode), or {} if none was."""
        plan = self.scheduler.schedule()
        if self._host:
            # install the in-flight ticket's tokens and histograms BEFORE
            # admission or chunks overwrite their slots' rows: the workers
            # sampled step t while this thread ran ahead, and step t+1's
            # forward consumes their tokens. The request-state commit still
            # lands at the drain point, one step behind.
            self._resolve_host_pending()
        if plan.new_requests:
            self._admit(plan.new_requests)
        if plan.new_chunked:
            self._admit_chunked(plan.new_chunked)
        if plan.chunks:
            self._run_chunks(plan.chunks)
        # refresh decode activity: a prompt's first token may already
        # satisfy the stop condition; chunk finishers join the decode batch
        plan.active_slots = self._decode_activity()
        if self._paged and plan.active_slots.any():
            # grow each decoding row's allocation by one token (preempting
            # under pressure) and publish the refreshed block table
            plan.active_slots = self._prepare_paged_decode(plan)
            self._push_block_table()
        dispatched = bool(plan.active_slots.any())
        if dispatched:
            # host arrays are copied on upload or snapshot: the engine
            # mutates _nonce/_pos/_sp after dispatch
            graphs = self._graphs_on()
            active = bind(self._statics()["active"], plan.active_slots) \
                if graphs else to_device(plan.active_slots, self.device)
            t_disp = time.perf_counter()
            with self.tracer.span("dispatch", device=self.device,
                                  step=plan.step,
                                  rows=int(plan.active_slots.sum())) as span:
                replayed = self._dispatch(plan, active, t_disp, graphs)
                span.set(graph=int(replayed))
            if replayed:
                self._metrics.graph_replays.inc()
            self._pos += plan.active_slots
            if self._paged:
                self._slot_len += plan.active_slots
        # drain: sequential mode syncs now; overlapped mode keeps exactly
        # one decode in flight so the device never waits on the host
        keep = 1 if (self.ecfg.overlap and dispatched) else 0
        rec: Optional[StepRecord] = None
        while len(self._pending) > keep:
            rec = self._drain_one() or rec
        return rec if rec is not None else {}

    def _dispatch(self, plan, active: torch.Tensor, t_disp: float,
                  graphs: bool) -> bool:
        """Enqueue the decode step of ``plan`` and queue its pending
        result. Returns whether every program of the step was a CUDA
        graph's replay."""
        logits, replayed = self._forward(active, graphs)
        if self._host:
            # §13: enqueue the forward-only step and the logits' copy
            # to pinned memory behind it, and hand the copy to the pool
            # — the workers, not this thread, wait for the device
            ticket = self.client.submit(
                HostCopy(logits), self.pstate, self._sp.host_params(),
                self._sp.host_bias(), self._nonce.copy(),
                self._pos.copy(), plan.step, plan.active_slots.copy())
            self._pending.append(_Pending(
                kind="host", ticket=ticket, step=plan.step,
                active=plan.active_slots.copy(),
                slot_request=list(plan.slot_request),
                t_dispatch=t_disp))
            return replayed
        with self.tracer.span("device_sample", device=self.device,
                              program="decode", rows=logits.shape[0],
                              step=plan.step):
            tokens, stats, decided = self._decide(logits, active, plan.step,
                                                  graphs)
        self.last_tokens = tokens
        self._pending.append(_Pending(
            fetch=HostCopy(tokens, stats), step=plan.step,
            active=plan.active_slots.copy(),
            slot_request=list(plan.slot_request),
            t_dispatch=t_disp))
        return replayed and decided

    # -- the decode step as CUDA graphs (engine/step_graph.py) ---------------
    def _graphs_on(self) -> bool:
        """Whether the decode step may run as CUDA graphs: on a CUDA device
        with no active mesh (a mesh's collectives stay eager)."""
        return self._graph_device and not dist.get_ctx().active

    def _statics(self) -> dict:
        """The device buffers of the per-step inputs that every graph of
        this engine reads: the active mask, the (B, 3) uniforms and the
        last tokens."""
        if self._static is None:
            B, d = self.ecfg.max_batch, self.device
            self._static = {
                "active": torch.zeros((B,), dtype=torch.bool, device=d),
                "u": torch.zeros((B, 3), dtype=torch.float32, device=d),
                "last": torch.zeros((B,), dtype=torch.int32, device=d)}
        return self._static

    def _graph(self, key: tuple, owner, make) -> Optional[StepGraph]:
        """Variant ``key``'s graph (the program, then what the engine
        observes of it: bias rows, the tracer on), or None where the step
        is to run eagerly. A variant's first use runs eagerly (it builds
        and loads what a capture cannot: the kernel library, cuBLAS's
        handles, the allocator's blocks); its second captures the graph by
        ``make()``. A graph captured under another ``owner`` (the weights,
        the sampler backend) is captured again."""
        if key not in self._graphs:
            self._graphs[key] = None
            return None
        g = self._graphs[key]
        if g is None or g.owner is not owner:
            if self._capture_stream is None:
                self._capture_stream = torch.cuda.Stream(self.device)
            g = self._graphs[key] = make()
            self._metrics.graph_captures.inc()
        return g

    def _drop_graphs(self, kind: Optional[str] = None) -> None:
        """Forget the captured graphs (``kind`` "forward" or "decide":
        those alone), and the memory they hold; a dropped variant runs
        eagerly once and is captured again."""
        for key in [k for k in self._graphs if kind in (None, k[0])]:
            del self._graphs[key]

    def _forward(self, active: torch.Tensor, graphs: bool):
        """The decode forward's logits, and whether they came from the
        forward graph's replay: the cache leaves and ``len`` are the
        graph's own tensors, written in place. The per-step inputs are
        in their buffers before a capture, so a capture can run them."""
        g = None
        if graphs:
            self.last_tokens = bind(self._statics()["last"], self.last_tokens)
            g = self._graph(("forward", obs_tracer.current().enabled),
                            self.params, self._capture_forward)
        if g is None:
            logits, self.cache = self._forward_impl(
                self.params, self.cache, self.last_tokens, active)
            return logits, False
        leaves = g.inputs
        for name, leaf in leaves.items():
            bind(leaf, self.cache[name])
        self.cache = dict(leaves)
        g.replay()
        return g.out, True

    def _capture_forward(self) -> StepGraph:
        """The forward graph over the engine's cache leaves: a leaf the
        forward returns out of place (``len``, a recurrent state) is
        copied back into the engine's tensor inside the graph."""
        cache, st = dict(self.cache), self._statics()

        def body():
            logits, out = self._forward_impl(self.params, cache, st["last"],
                                             st["active"])
            for name, leaf in out.items():
                if leaf is not cache[name]:
                    cache[name].copy_(leaf)
            return logits

        graph, logits = capture(self.device, body, self._capture_stream)
        return StepGraph(graph, cache, logits, self.params)

    def _decide(self, logits, active: torch.Tensor, step: int,
                graphs: bool):
        """The device decision of a decode step: (tokens, stats, whether
        they came from the decide graph's replay). The uniforms are drawn
        on the host either way; the histograms are the graph's own
        tensors, written in place."""
        sp, bias = self._sp.as_params(), self._sp.bias_array()
        u = self.decision.uniforms_tagged(self._nonce, self._pos,
                                          seeds=sp.seed, use_seed=sp.use_seed)
        u = bind(self._statics()["u"], u) if graphs \
            else to_device(u, self.device)
        backend = self.decision._resolve_backend()
        g = None
        if graphs and not backend.keys_step:
            g = self._graph(
                ("decide", bias is not None, obs_tracer.current().enabled),
                backend,
                lambda: self._capture_decide(logits, sp, bias, step,
                                             backend))
        if g is None:
            tokens, self.pstate, stats = self._decide_impl(
                logits, self.pstate, sp, bias, u, step, active)
            return tokens, stats, False
        ins = g.inputs
        bind(ins[0], logits)
        for dst, src in zip(ins[1:3], self.pstate):
            bind(dst, src)
        self.pstate = pen.PenaltyState(*ins[1:3])
        # the rows' contract: copied only when a row has changed
        if g.sources.get("sp") is not sp:
            for dst, src in zip(ins[3:10], sp):
                bind(dst, src)
            g.sources["sp"] = sp
        if bias is not None and g.sources.get("bias") is not bias:
            bind(ins[10], bias)
            g.sources["bias"] = bias
        g.replay()
        tokens, stats = g.out
        return tokens, stats, True

    def _capture_decide(self, logits, sp: SamplingParams, bias, step: int,
                        backend) -> StepGraph:
        """The decide graph over the logits it is handed, the engine's
        histograms and the rows' contract: the histograms the decision
        returns out of place are copied back inside the graph. ``step``
        is captured as it is: only a backend that reads it (``keys_step``)
        could tell, and that one runs eagerly."""
        st = self._statics()
        ins = [logits, *self.pstate, *sp[:7]] + \
            ([bias] if bias is not None else [])
        params = SamplingParams(*ins[3:10])
        state = pen.PenaltyState(*ins[1:3])

        def body():
            tokens, new, stats = self._decide_impl(
                logits, state, params, ins[10] if bias is not None else None,
                st["u"], step, st["active"])
            for dst, src in zip(state, new):
                if src is not dst:
                    dst.copy_(src)
            return tokens, stats

        graph, out = capture(self.device, body, self._capture_stream)
        g = StepGraph(graph, ins, out, backend)
        g.sources.update(sp=sp, bias=bias)
        return g

    @locked_api
    @traced_api
    def flush(self) -> None:
        """Commit every in-flight iteration and retire what finished."""
        while self._pending:
            self._drain_one()
        self.scheduler.retire_finished()

    def run(self, max_steps: int = 10_000) -> List[Request]:
        steps = 0
        while (self.scheduler.has_work or self._pending) and \
                steps < max_steps:
            self.step()
            steps += 1
        self.flush()
        return self.scheduler.finished

    def generate(self, requests: List[Request], max_steps: int = 10_000):
        """Submit ``requests`` and stream :class:`GenerationEvent` items as
        their tokens **commit** (one step after dispatch under the
        overlapped loop). Raises ``RuntimeError`` if ``max_steps`` runs out
        with requests still open."""
        yield from generate_stream(self, requests, max_steps)

    def close(self) -> None:
        """Commit in-flight iterations, shut down the sampler pool's worker
        threads and refuse further submissions. Idempotent, and safe on a
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
                    getattr(self, "_pending", None) is not None:
                self.flush()
            if getattr(self, "_graphs", None) is not None:
                self._drop_graphs()
            client = getattr(self, "client", None)
            if client is not None:
                client.close()

    # -- KV migration (prefill/decode disaggregation, DESIGN.md §18) --------
    @locked_api
    def export_request(self, request_id: int) -> KVPayload:
        """Quiesce one RUNNING request at the commit boundary and detach
        it as a :class:`KVPayload` (DESIGN.md §18).

        The quiesce point is ``flush()``: every dispatched token is
        committed (a host-mode ticket in flight is resolved first), so the
        cache holds ``T`` entries covering the prefilled window plus
        all-but-the-last committed token, ``last_tokens[slot]`` is
        ``output[-1]`` (sampled but not yet forwarded), the histograms
        already count it, and the RNG position is ``len(output)``. The
        K/V rows are copied on this engine's device, the histogram rows
        where they live (the host in host placement).

        Raises ``KeyError`` for an unknown/unslotted id and ``ValueError``
        for a request that cannot migrate (mid-chunked-prefill, no
        committed output yet, or already finished — the flush may finish
        it, in which case it retires here and there is nothing to move).
        """
        self.flush()
        req = next((s for s in self.scheduler.slots
                    if s is not None and s.request_id == request_id), None)
        if req is None:
            raise KeyError(
                f"request {request_id} is not slotted on this engine")
        if req.state is not RequestState.RUNNING or not req.output:
            raise ValueError(
                f"request {request_id} cannot migrate: state={req.state}, "
                f"{len(req.output)} committed tokens (needs a RUNNING "
                "request past its first token)")
        if req.should_stop():
            raise ValueError(f"request {request_id} already finished")
        t0 = time.perf_counter()
        slot = req.slot
        assert int(self._pos[slot]) == len(req.output), \
            "quiesce invariant violated: RNG position != committed output"
        if self._paged:
            T = int(self._slot_len[slot])
            k, v = gather_slot_kv(self.cache, self.alloc.owned[slot], T,
                                  self.pcfg)
            self.alloc.export_slot(slot)
            self._slot_len[slot] = 0
        else:
            if set(self.cache) != {"k", "v", "len", "pos"}:
                raise RuntimeError(
                    "KV migration supports plain attention caches only "
                    f"(leaves: {sorted(self.cache)})")
            T = int(self.cache["len"][slot])
            k = self.cache["k"][:, slot, :T].clone()
            v = self.cache["v"][:, slot, :T].clone()
        payload = KVPayload(
            request_id=req.request_id, prompt=list(req.prompt),
            output=list(req.output), max_new_tokens=req.max_new_tokens,
            sampling=req.sampling, eos_token=req.eos_token,
            prompt_offset=req.prompt_offset,
            arrival_time=req.arrival_time, kv_len=T, k=k, v=v,
            prompt_counts=self.pstate.prompt_counts[slot].clone(),
            output_counts=self.pstate.output_counts[slot].clone(),
            last_token=int(req.output[-1]), next_pos=len(req.output),
            source=f"engine@{id(self):x}", request=req)
        # detach: frees the slot (on_free releases any remaining block
        # claim and resets the SlotParams row) without re-queueing
        self.scheduler.remove(req)
        req.kv_payload = payload
        self.migrations_out += 1
        self._metrics.migrations_out.inc()
        if self._paged:
            self._metrics.free_blocks.set(float(self.alloc.num_free))
        stamp_export(payload)
        if self.tracer.enabled:
            self.tracer.add("kv_migrate", t0, payload.exported_at,
                            name=f"export#{req.request_id}",
                            request_id=int(req.request_id), kv_len=T,
                            bytes=payload.nbytes, direction="out")
        return payload

    @locked_api
    def import_request(self, payload: KVPayload) -> Request:
        """Admit a migrated request carrying its KV (DESIGN.md §18): the
        payload rides through the normal admission path (queueing, slot
        assignment, block gating) and ``_admit`` installs it directly —
        no re-prefill. Returns the request object that will stream here."""
        self._validate_payload(payload)
        req = payload.request if payload.request is not None \
            else payload.to_request()
        req.kv_payload = payload
        req.slot = -1
        req.state = RequestState.WAITING
        req.prompt_pos = 0
        self.submit([req])
        self._metrics.pending_imports.set(float(self._pending_imports()))
        return req

    def _pending_imports(self) -> int:
        return sum(1 for r in self.scheduler.waiting
                   if r.kv_payload is not None)

    def _validate_payload(self, p: KVPayload) -> None:
        L = self.cfg.num_layers
        kv, hd = self.cfg.num_kv_heads, self.cfg.resolved_head_dim
        want = (L, p.kv_len, kv, hd)
        if tuple(p.k.shape) != want or tuple(p.v.shape) != want:
            raise ValueError(
                f"payload KV shape {tuple(p.k.shape)} does not match this "
                f"engine's model ({want})")
        if tuple(p.prompt_counts.shape) != (self.cfg.vocab_size,):
            raise ValueError(
                f"payload vocab {p.prompt_counts.shape[0]} != "
                f"{self.cfg.vocab_size}")
        if p.kv_len + 1 > self.ecfg.max_seq_len:
            raise ValueError(
                f"payload of {p.kv_len} KV entries cannot decode within "
                f"max_seq_len={self.ecfg.max_seq_len}")
        if p.next_pos != len(p.output) or not p.output:
            raise ValueError("corrupt payload: RNG position != output")

    def _install_imports(self, carried: List[Request]) -> None:
        """Install migrated requests' state into their assigned slots —
        the import half of the migration seam (DESIGN.md §18), in place of
        ``_admit``'s prefill: K/V copied bitwise into freshly allocated
        blocks (or the slot's slab rows) on this engine's device, the
        histogram rows into their home here (host or device, whatever the
        exporter's placement was), the sampling contract into the slot's
        row, and the RNG position resumed at ``len(output)``."""
        d, home = self.device, self._pstate_home
        for r in carried:
            p: KVPayload = r.kv_payload
            # consumed on install: a later preemption of this request
            # falls back to recompute-on-resume over prompt+output
            r.kv_payload = None
            t0 = time.perf_counter()
            if self.tracer.enabled and p.exported_at:
                self.tracer.add("handoff_wait", p.exported_at, t0,
                                name=f"handoff#{r.request_id}",
                                request_id=int(r.request_id),
                                kv_len=int(p.kv_len))
            slot, T = r.slot, int(p.kv_len)
            if self._paged:
                self.alloc.release(slot)       # stale claims (defensive)
                self.alloc.ensure(slot, T)
                self._slot_len[slot] = T
                self._push_block_table()
                scatter_slot_kv(self.cache, self.alloc.owned[slot], p.k, p.v,
                                self.pcfg)
            else:
                for name, rows in (("k", p.k), ("v", p.v)):
                    leaf = self.cache[name]
                    leaf[:, slot, :T] = rows.to(d, leaf.dtype,
                                                non_blocking=True)
            self.cache["len"][slot] = T
            self.pstate.prompt_counts[slot] = p.prompt_counts.to(home)
            self.pstate.output_counts[slot] = p.output_counts.to(home)
            self.last_tokens = self.last_tokens.index_put(
                (to_device(np.array([slot]), d),),
                to_device(np.array([p.last_token], np.int32), d))
            self._sp.set_row(slot, r.sampling)
            self._nonce[slot] = np.uint32(r.request_id)
            self._pos[slot] = int(p.next_pos)
            r.handoff_count += 1
            self.migrations_in += 1
            self._metrics.migrations_in.inc()
            if self.tracer.enabled:
                self.tracer.add("kv_migrate", t0, time.perf_counter(),
                                name=f"import#{r.request_id}",
                                request_id=int(r.request_id), kv_len=T,
                                bytes=p.nbytes, direction="in")
        if self._paged:
            self._metrics.free_blocks.set(float(self.alloc.num_free))
        self._metrics.pending_imports.set(float(self._pending_imports()))

    @locked_api
    def migration_stats(self) -> dict:
        """Per-engine disaggregation counters for ``GET /v1/stats`` —
        free-block headroom and migration flow (DESIGN.md §18)."""
        return {
            "free_blocks": self.alloc.num_free if self._paged else None,
            "migrations_in": self.migrations_in,
            "migrations_out": self.migrations_out,
            "pending_imports": self._pending_imports(),
        }

    # -- commit ---------------------------------------------------------------
    def _resolve(self, ent: _Pending) -> None:
        """Block on a host-mode ticket (the measured pool stall) and install
        its tokens (a non_blocking upload) and histograms."""
        t0 = time.perf_counter()
        ent.res = ent.ticket.result()
        t1 = time.perf_counter()
        ent.stall = t1 - t0
        if self.tracer.enabled:
            self.tracer.add("pool_stall", t0, t1,
                            name=f"stall@step{ent.step}", step=ent.step)
        self.last_tokens = to_device(ent.res.tokens, self.device)
        self.pstate = ent.res.state

    def _resolve_host_pending(self) -> None:
        """Host mode (§13): install every in-flight ticket's sampled tokens
        and updated histograms so the next dispatch can consume them.
        Idempotent; the scheduler-side commit stays at the drain point."""
        for ent in self._pending:
            if ent.kind == "host" and ent.res is None:
                self._resolve(ent)

    def _drain_one(self) -> Optional[StepRecord]:
        """Wait for the oldest pending result's tokens and commit them — the
        only place an iteration blocks on the device (device mode) or the
        sampler pool (host mode, if not already resolved). A chunk
        program's first tokens are recorded and make no StepRecord."""
        ent = self._pending.pop(0)
        if ent.kind == "host":
            if ent.res is None:       # sequential mode drains immediately
                self._resolve(ent)
            toks_np, stats = ent.res.tokens, None
        else:
            with self.tracer.span("fetch_wait", step=ent.step):
                vals = [v.numpy() for v in ent.fetch.wait()]
            toks_np, stats = vals[0], (vals[1] if len(vals) > 1 else None)
        now = time.perf_counter()
        if ent.kind == "first":
            for slot, req in ent.finishers:
                req.record_token(int(toks_np[slot]), now)
            return None
        if ent.kind == "decode" and self.tracer.enabled:
            # dispatch -> host arrival of the decode step's tokens
            self.tracer.add("forward", ent.t_dispatch, now,
                            name=f"decode@step{ent.step}", step=ent.step)
        self.scheduler.commit(toks_np, ent.slot_request, ent.active, now=now)
        if self.tracer.enabled:
            self.tracer.add("commit", now, time.perf_counter(),
                            name=f"commit@step{ent.step}", step=ent.step)
        common = dict(step=ent.step, batch=int(ent.active.sum()),
                      queue_depth=float(len(self.scheduler.waiting)),
                      queue_delay_ms=self._queue_delay_ms())
        if ent.kind == "host":
            rec = StepRecord(accept_rate=ent.res.accept_rate,
                             alpha_mean=ent.res.alpha_mean,
                             fallback_rate=ent.res.fallback_rate,
                             stall_ms=ent.stall * 1e3,
                             sampler_ms=ent.res.sampler_time * 1e3,
                             transfer_ms=ent.res.transfer_time * 1e3,
                             **common)
        else:
            rec = StepRecord(accept_rate=float(stats[0]),
                             alpha_mean=float(stats[1]),
                             fallback_rate=float(stats[2]), **common)
        if self._controller is not None:
            new_h = self._controller.observe(rec.alpha_mean)
            if new_h:
                self._apply_hot_size(new_h)
                rec.hot_size = new_h
        if self._dpc is not None:
            act = self._dpc.observe_record(rec)
            if act:
                self._apply_action(act, rec)
        self._metrics.observe_step(rec)
        if self._paged:
            self._metrics.free_blocks.set(float(self.alloc.num_free))
        self.stats_log.append(rec)
        return rec

    def _apply_action(self, act, rec: StepRecord) -> None:
        """Apply a :class:`DecisionPlaneController` action and stamp it on
        the step's record."""
        if act.hot_size is not None:
            self._apply_hot_size(act.hot_size)
            rec.hot_size = act.hot_size
        if act.samplers is not None:
            # resolving first keeps the drained ticket's result installed
            # before the executor recycle
            self._resolve_host_pending()
            self.client.resize_pool(act.samplers)
            rec.samplers = act.samplers
            self._metrics.pool_workers.set(float(act.samplers))
        if act.sampler_mode is not None:
            self.set_sampler_mode(act.sampler_mode)
            rec.sampler_mode = act.sampler_mode
        self._metrics.decisions.inc()
        if self.tracer.enabled:
            self.tracer.instant(
                "decision", name=f"decision@step{rec.step}", step=rec.step,
                hot_size=act.hot_size, samplers=act.samplers,
                sampler_mode=act.sampler_mode)

    def set_sampler_mode(self, mode: str) -> bool:
        """Re-route the decision plane online (§15): resolve the in-flight
        host ticket FIRST — after a host->device switch the top-of-step
        resolution no longer fires — then re-route the client and move the
        histograms to their new home (a copy to the host waits for the
        stream once). The per-entry ``_Pending.kind`` commits
        mixed-placement in-flight work correctly on either side, so the
        switch cannot move any request's stream. Returns True iff the mode
        changed."""
        mode = canonical_sampler_mode(mode)
        if mode == self.client.mode:
            return False
        self._resolve_host_pending()
        self.client.set_mode(mode)
        self._host = self.client.is_host
        self.pstate = _move_state(self.pstate, self._pstate_home)
        # the histograms have moved: the decide graph held the old ones
        self._drop_graphs("decide")
        self._metrics.mode_host.set(1.0 if self._host else 0.0)
        return True

    def _apply_hot_size(self, new_h: int) -> None:
        """Swap the SHVS hot set to ``new_h`` ids. An in-flight ticket's
        workers read the pool's plane when they run: join them BEFORE the
        swap so their batch samples against the hot set it was dispatched
        under (as an enqueued device step does) — never a wall-clock
        race."""
        self._resolve_host_pending()
        from repro_torch.core.hot_vocab import build_hot_set
        self.decision.hot_set = build_hot_set(
            self._hot_counts, new_h, self.cfg.vocab_size, device=self.device)
        self.client.refresh()
        # a new backend: the decide graph captured the old hot set
        self._drop_graphs("decide")

    def _queue_delay_ms(self) -> float:
        """Oldest waiting request's queueing delay; NaN when arrivals carry
        no wall-clock stamps."""
        if not self.scheduler.waiting:
            return 0.0
        now = time.perf_counter()
        ds = [now - r.arrival_time
              for r in self.scheduler.waiting if r.arrival_time]
        return max(ds) * 1e3 if ds else float("nan")

    # -- admission ------------------------------------------------------------
    def _trace_queue_wait(self, requests: List[Request], t: float) -> None:
        """Arrival -> admission wait per request (requests with no arrival
        stamp are skipped)."""
        if self.tracer.enabled:
            for r in requests:
                if r.arrival_time:
                    self.tracer.add("queue_wait", r.arrival_time, t,
                                    name=f"wait#{r.request_id}",
                                    request_id=int(r.request_id))

    def _admit(self, new_requests: List[Request]) -> None:
        """Prefill new requests (padded batch) and insert their rows into
        the batch state at their slots (in place, behind any decode still
        running on the stream). A resumed request (re-queued by preemption
        with committed output) re-prefills prompt + output and samples its
        next token at output position len(output): the (request, position)
        RNG keying continues its stream. The draw runs on the device in
        either placement; in host mode the rows' histograms then cross to
        the host (this admission waits for the prefill anyway).

        A *migrated* request (carrying a :class:`KVPayload`, §18) skips
        the prefill: its KV, histogram rows and RNG position are installed
        bitwise into the assigned slot (:meth:`_install_imports`)."""
        carried = [r for r in new_requests if r.kv_payload is not None]
        if carried:
            self._install_imports(carried)
            cids = {id(r) for r in carried}
            new_requests = [r for r in new_requests if id(r) not in cids]
            if not new_requests:
                return
        t_pf = time.perf_counter()
        self._trace_queue_wait(new_requests, t_pf)
        first, rows_cache, rows_pstate, lens, bases, rids = \
            prefill_new_rows(self, new_requests, self.scheduler.step)
        slot_ids = np.array([r.slot for r in new_requests], np.int64)
        slots = to_device(slot_ids, self.device)
        if self._paged:
            self._paged_insert(new_requests, rows_cache, lens)
        else:
            _insert_rows(self.cache, rows_cache, slots)
        home = self._pstate_home
        hslots = to_device(slot_ids, home)
        for dst, src in zip(self.pstate, rows_pstate):
            dst[hslots] = src.to(home)
        self.last_tokens = self.last_tokens.index_put((slots,), first)
        now = time.perf_counter()
        first_np = first.cpu().numpy()   # blocks on the prefill
        if self.tracer.enabled:
            self.tracer.add("prefill", t_pf, time.perf_counter(),
                            name=f"prefill x{len(new_requests)}",
                            rows=len(new_requests))
        for i, r in enumerate(new_requests):
            self._sp.set_row(r.slot, r.sampling)
            self._nonce[r.slot] = rids[i]
            self._pos[r.slot] = int(bases[i]) + 1
            r.record_token(int(first_np[i]), now)

    def _paged_insert(self, new_requests: List[Request], rows_cache,
                      lens: np.ndarray) -> None:
        """Scatter freshly prefilled contiguous rows ((L, P, Sc, kv, hd))
        into the block pool: allocate each slot's blocks, publish the
        table, then write the first lens[p] entries of row p into its
        slot's blocks, in place."""
        for i, r in enumerate(new_requests):
            self.alloc.release(r.slot)         # stale claims (defensive)
            self.alloc.ensure(r.slot, int(lens[i]))
            self._slot_len[r.slot] = int(lens[i])
        self._push_block_table()
        d = self.device
        slot_ids = np.asarray([r.slot for r in new_requests], np.int64)
        row_bt = to_device(self.alloc.table(self.ecfg.max_batch)[slot_ids], d)
        true_lens = to_device(lens, d)
        Sc = rows_cache["k"].shape[2]
        valid = torch.arange(Sc, device=d)[None, :] < true_lens[:, None]
        flat = flat_block_indices(row_bt, torch.zeros_like(true_lens), valid,
                                  self.pcfg.block_size, self.pcfg.num_blocks)
        scatter_block_kv(self.cache["k_pool"], rows_cache["k"], flat)
        scatter_block_kv(self.cache["v_pool"], rows_cache["v"], flat)
        self.cache["len"][to_device(slot_ids, d)] = true_lens

    def _admit_chunked(self, new_chunked: List[Request]) -> None:
        """Claim slots for chunked-prefill requests: reset the rows' cache
        offsets and seed their penalty state with the full-prompt histogram
        (available up front — Eq. 5 is position-independent), where the
        histograms live."""
        self._trace_queue_wait(new_chunked, time.perf_counter())
        P = len(new_chunked)
        windows = [r.prompt[r.prompt_offset:] for r in new_chunked]
        maxlen = max(len(w) for w in windows)
        toks = np.zeros((P, maxlen), np.int32)
        lens = np.zeros((P,), np.int32)
        for i, w in enumerate(windows):
            toks[i, :len(w)] = w
            lens[i] = len(w)
        home = self._pstate_home
        rows_pstate = pen.init_state(P, self.cfg.vocab_size,
                                     to_device(toks, home),
                                     to_device(lens, home), device=home)
        slot_ids = np.array([r.slot for r in new_chunked], np.int64)
        hslots = to_device(slot_ids, home)
        for dst, src in zip(self.pstate, rows_pstate):
            dst[hslots] = src
        self.cache["len"][to_device(slot_ids, self.device)] = 0
        for r in new_chunked:
            self._sp.set_row(r.slot, r.sampling)
            self._nonce[r.slot] = np.uint32(r.request_id)
            self._pos[r.slot] = 0
            if self._paged:
                self.alloc.release(r.slot)     # stale claims (defensive)
                self._slot_len[r.slot] = 0

    def _run_chunks(self, chunks: List[ChunkTask]) -> None:
        """Run one prompt chunk per mid-prefill slot (one (B, C) program);
        rows that complete their prompt sample their first token and join
        the decode batch this iteration."""
        if self._paged:
            # grow each chunk row's allocation to cover its slab before
            # dispatch; a task whose request was evicted during another
            # task's recovery (or its own) is dropped — re-admission
            # restarts its prefill
            kept: List[ChunkTask] = []
            for task in chunks:
                if self.scheduler.slots[task.slot] is not task.request:
                    continue
                need = int(self._slot_len[task.slot]) + task.end - task.start
                if self._ensure_blocks(task.slot, need):
                    kept.append(task)
            chunks = [t for t in kept
                      if self.scheduler.slots[t.slot] is t.request]
            if not chunks:
                return
            self._push_block_table()
        B = self.ecfg.max_batch
        C = self.scheduler.prompt_chunk
        toks = np.zeros((B, C), np.int32)
        counts = np.zeros((B,), np.int32)
        mask = np.zeros((B,), bool)
        finish = np.zeros((B,), bool)
        finishers: List[Tuple[int, Request]] = []
        for task in chunks:
            seg = task.request.prompt[task.start:task.end]
            toks[task.slot, :len(seg)] = seg
            counts[task.slot] = len(seg)
            mask[task.slot] = True
            if task.final:
                finish[task.slot] = True
                finishers.append((task.slot, task.request))
        d = self.device
        pstate = self.pstate
        if self._host:
            # the chunk's draw runs on the device over the finishers' rows,
            # whose histograms live on the host in this mode: those rows
            # cross to the device, and back after the draw (which waits for
            # the chunk program; the other rows' results are discarded)
            fin = np.array([slot for slot, _ in finishers], np.int64)
            hfin, dfin = torch.from_numpy(fin), to_device(fin, d)
            pstate = pen.PenaltyState(*(
                torch.zeros(t.shape, dtype=t.dtype, device=d)
                for t in self.pstate))
            for dst, src in zip(pstate, self.pstate):
                dst[dfin] = src[hfin].to(d, non_blocking=True)
        first, self.last_tokens, self.cache, pstate = self._chunk_impl(
            self.params, self.cache, pstate, to_device(toks, d),
            to_device(counts, d), to_device(mask, d), to_device(finish, d),
            self._sp.as_params(), self._sp.bias_array(), self._nonce.copy(),
            self.last_tokens, self.scheduler.step)
        if self._host:
            for dst, src in zip(self.pstate, pstate):
                dst[hfin] = src[dfin].cpu()
        else:
            self.pstate = pstate
        if self._paged:
            for task in chunks:
                self._slot_len[task.slot] += task.end - task.start
        for slot, _ in finishers:
            self._pos[slot] = 1
        if finishers:
            # first tokens reach the host through the pending queue, by the
            # same pinned copy and event as a decode step's
            self._pending.append(_Pending(fetch=HostCopy(first), kind="first",
                                          finishers=finishers))


def _insert_rows(batch_cache, rows_cache, slots) -> None:
    """Write per-row cache entries into the engine's batch cache at
    ``slots``, in place: every leaf but ``len`` and ``pos`` is (L|G, B,
    ...) with the batch on axis 1 (K/V and recurrent states alike, so an
    admitted row never decodes from its slot's previous state); ``len``
    is (B,); the scalar ``pos`` is left alone."""
    for name, leaf in batch_cache.items():
        if name == "len":
            leaf[slots] = rows_cache[name]
        elif name != "pos":
            leaf[:, slots] = rows_cache[name]


class SlotParams:
    """Per-slot sampling contract rows as numpy arrays -> SamplingParams.

    One row per batch slot: the 7 core controls (``greedy`` is realized as
    temperature 0), the per-request RNG seed tags, and dense logit-bias
    rows. The device tensors are cached and rebuilt only after a row
    changes; every lifecycle edge that reassigns a slot goes through
    :meth:`set_row` or :meth:`reset_row`, both of which drop the cache.
    """

    def __init__(self, batch: int, vocab_size: int, device):
        self.batch = batch
        self.vocab_size = vocab_size
        self.device = torch.device(device)
        self.temperature = np.ones(batch, np.float32)
        self.top_k = np.zeros(batch, np.int32)
        self.top_p = np.ones(batch, np.float32)
        self.min_p = np.zeros(batch, np.float32)
        self.repetition = np.ones(batch, np.float32)
        self.presence = np.zeros(batch, np.float32)
        self.frequency = np.zeros(batch, np.float32)
        self.seed = np.zeros(batch, np.uint32)
        self.use_seed = np.zeros(batch, bool)
        # dense (B, V) bias rows, allocated on first use; sticky once any
        # request used logit_bias (zero rows are exact no-ops)
        self._bias_dense: Optional[np.ndarray] = None
        self._cached: Optional[SamplingParams] = None
        self._bias_cached: Optional[torch.Tensor] = None
        # CPU copies of the rows for the host sampler pool (a snapshot its
        # workers read while the engine moves on)
        self._host_cached: Optional[SamplingParams] = None
        self._host_bias: Optional[torch.Tensor] = None

    def set_row(self, i: int, cfg: SamplingConfig) -> None:
        self.temperature[i] = cfg.effective_temperature
        self.top_k[i] = cfg.top_k
        self.top_p[i] = cfg.top_p
        self.min_p[i] = cfg.min_p
        self.repetition[i] = cfg.repetition_penalty
        self.presence[i] = cfg.presence_penalty
        self.frequency[i] = cfg.frequency_penalty
        self.seed[i] = np.uint32(cfg.seed_u32)
        self.use_seed[i] = cfg.seeded
        if cfg.logit_bias and self._bias_dense is None:
            self._bias_dense = np.zeros((self.batch, self.vocab_size),
                                        np.float32)
        if self._bias_dense is not None:
            self._bias_dense[i] = 0.0
            for t, b in cfg.logit_bias:
                if 0 <= t < self.vocab_size:
                    self._bias_dense[i, t] += b
            self._bias_cached = None
            self._host_bias = None
        self._cached = None
        self._host_cached = None

    def reset_row(self, i: int) -> None:
        """Return row ``i`` to the default contract when its slot frees."""
        self.set_row(i, SamplingConfig())

    def _params_on(self, d: torch.device) -> SamplingParams:
        return SamplingParams(
            temperature=to_device(self.temperature, d),
            top_k=to_device(self.top_k, d),
            top_p=to_device(self.top_p, d),
            min_p=to_device(self.min_p, d),
            repetition_penalty=to_device(self.repetition, d),
            presence_penalty=to_device(self.presence, d),
            frequency_penalty=to_device(self.frequency, d),
            seed=self.seed.copy(),
            use_seed=self.use_seed.copy(),
        )

    def as_params(self) -> SamplingParams:
        if self._cached is None:
            self._cached = self._params_on(self.device)
        return self._cached

    def host_params(self) -> SamplingParams:
        """The rows as CPU tensors, for the host sampler pool."""
        if self._host_cached is None:
            self._host_cached = self._params_on(torch.device("cpu"))
        return self._host_cached

    def bias_array(self) -> Optional[torch.Tensor]:
        """Dense (B, V) logit-bias operand, or None while no request has
        ever used logit_bias."""
        if self._bias_dense is None:
            return None
        if self._bias_cached is None:
            self._bias_cached = to_device(self._bias_dense, self.device)
        return self._bias_cached

    def host_bias(self) -> Optional[torch.Tensor]:
        """:meth:`bias_array` as a CPU tensor, for the host sampler pool."""
        if self._bias_dense is None:
            return None
        if self._host_bias is None:
            self._host_bias = to_device(self._bias_dense, torch.device("cpu"))
        return self._host_bias
