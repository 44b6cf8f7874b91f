"""The serving engine: continuous batching + the SIMPLE decision plane.

The engine's iteration (paper §4.2, DESIGN.md §2):

  ⓪ scheduler.schedule()            — retire / admit / emit scheduling output
  ① prefill newly admitted requests — monolithic, rows inserted into slots
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

Determinism: uniforms are keyed on (request-id, output position), drawn
on the host bit-equal to the reference's ``jax.random`` stream, so each
request's tokens are the same in overlapped and sequential mode and do
not depend on slot placement or admission timing.

This slice runs the contiguous KV cache, the decision plane on the
device, and monolithic prefill. Paged KV, chunked prefill, host/adaptive
placement, autotuning and KV migration raise ``NotImplementedError``
naming their ROADMAP item; there is no tracer or metrics registry yet.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig, SamplingConfig, SHVSConfig
from repro_torch.core import penalties as pen
from repro_torch.core.decision_plane import DecisionPlane
from repro_torch.core.sampling import SamplingParams
from repro_torch.device import resolve_device, to_device
from repro_torch.engine.request import Request, RequestState
from repro_torch.engine.scheduler import Scheduler
from repro_torch.models.model import Model
from repro_torch.obs.records import StepRecord


@dataclass
class EngineConfig:
    max_batch: int = 8               # batch slots (B)
    max_seq_len: int = 512           # cache capacity per slot
    algorithm: str = "shvs"          # decision-plane algorithm
    shvs: SHVSConfig = SHVSConfig()
    k_cap: int = 256
    seed: int = 0
    prompt_bucket: int = 32          # prompts padded to multiples of this
    overlap: bool = True             # double-buffered iteration loop (§2)
    prompt_chunk: int = 0            # >0: chunked prefill (not ported)
    priority_admission: bool = True
    max_admission_wait: int = 64
    cache: str = "contiguous"        # "paged" is not ported
    sampler_mode: str = "device"     # "host"/"adaptive" are not ported
    stats_window: int = 4096         # stats_log ring size


def _unported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP 'Modules to port' item {item})")


def _check_slice(ecfg: EngineConfig) -> None:
    if ecfg.cache != "contiguous":
        raise _unported(f"cache={ecfg.cache!r}", 6)
    if ecfg.prompt_chunk > 0:
        raise _unported("chunked prefill (prompt_chunk > 0)", 6)
    if ecfg.sampler_mode != "device":
        raise _unported(f"sampler_mode={ecfg.sampler_mode!r}", 8)


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
    """Admission math: bucket and pad the prompts, run the monolithic
    prefill and sample each row's first token (output position 0).
    Requests resumed with committed output come with preemption and KV
    migration (ROADMAP items 6 and 9) and are not admitted here.

    Returns ``(first, rows_cache, rows_pstate, rids)`` — ``first`` is the
    (P,) device token tensor."""
    if any(r.output for r in new_requests):
        raise _unported("resuming a request with committed output", 6)
    P = len(new_requests)
    maxlen = max(r.prompt_len for r in new_requests)
    Sp = min(_bucket(maxlen, eng.ecfg.prompt_bucket), eng.ecfg.max_seq_len)
    toks = np.zeros((P, Sp), np.int32)
    lens = np.zeros((P,), np.int32)
    for i, r in enumerate(new_requests):
        c = r.prompt[-Sp:]
        toks[i, :len(c)] = c
        lens[i] = len(c)
    dev = eng.device
    logits, rows_cache, rows_pstate = eng._prefill_impl(
        eng.params, to_device(toks, dev), to_device(lens, dev))
    rids = np.array([r.request_id for r in new_requests], np.uint32)
    sp_rows = SlotParams(P, eng.cfg.vocab_size, dev)
    for i, r in enumerate(new_requests):
        sp_rows.set_row(i, r.sampling)
    first, rows_pstate, _ = eng.decision.step(
        logits, rows_pstate, sp_rows.as_params(), step_idx,
        rng_tags=(rids, np.zeros((P,), np.int32)),
        logit_bias=sp_rows.bias_array())
    return first, rows_cache, rows_pstate, rids


class _HostCopy:
    """A step's tokens and stats on their way to the host.

    On CUDA the copy into pinned memory is enqueued at dispatch, behind the
    step's own kernels and ahead of the next step's, and an event marks its
    end: the drain waits for this step only. On the CPU the values are
    cloned at dispatch (later in-place updates must not reach them)."""

    def __init__(self, tokens: torch.Tensor, stats):
        stats = torch.stack([s.float() for s in stats])
        self.event = None
        if tokens.is_cuda:
            self.tokens = torch.empty(tokens.shape, dtype=tokens.dtype,
                                      pin_memory=True)
            self.stats = torch.empty(stats.shape, dtype=stats.dtype,
                                     pin_memory=True)
            self.tokens.copy_(tokens, non_blocking=True)
            self.stats.copy_(stats, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.tokens = tokens.clone()
            self.stats = stats

    def wait(self):
        if self.event is not None:
            self.event.synchronize()
        return self.tokens.numpy(), self.stats.numpy()


@dataclass
class _Pending:
    """One dispatched-but-uncommitted decode iteration."""

    fetch: _HostCopy
    step: int
    active: np.ndarray                          # (B,) bool snapshot
    slot_request: List[Optional[Request]] = field(default_factory=list)


class Engine:
    """Serving engine over one device. ``device`` defaults to "cuda" and
    must match where ``params`` live; CUDA without a card raises."""

    def __init__(self, model_cfg: ModelConfig, params,
                 engine_cfg: EngineConfig, hot_set=None, hot_counts=None,
                 autotune: bool = False, device="cuda"):
        self._api_lock = threading.RLock()
        self._closed = False
        _check_slice(engine_cfg)
        if autotune or hot_counts is not None:
            raise _unported("hot-set autotuning", 8)
        self.device = resolve_device(device)
        self.cfg = model_cfg
        self.ecfg = engine_cfg
        self.model = Model(model_cfg)
        self.params = params
        B, S = engine_cfg.max_batch, engine_cfg.max_seq_len
        self.scheduler = Scheduler(
            B, prompt_chunk=0,
            priority_admission=engine_cfg.priority_admission,
            max_admission_wait=engine_cfg.max_admission_wait,
            max_prompt=S, on_free=self._on_slot_free)
        self.decision = DecisionPlane(
            model_cfg.vocab_size, algorithm=engine_cfg.algorithm,
            shvs=engine_cfg.shvs, hot_set=hot_set,
            k_cap=min(engine_cfg.k_cap, model_cfg.vocab_size),
            seed=engine_cfg.seed, device=self.device)
        self.cache = self.model.init_cache(B, S, device=self.device)
        self.pstate = self.decision.init_state(B)
        self.last_tokens = torch.zeros((B,), dtype=torch.int32,
                                       device=self.device)
        self._sp = SlotParams(B, model_cfg.vocab_size, self.device)
        # per-slot RNG tags: request nonce + next output position (host)
        self._nonce = np.zeros((B,), np.uint32)
        self._pos = np.zeros((B,), np.int32)
        self._pending: List[_Pending] = []
        self.stats_log: Deque[StepRecord] = deque(
            maxlen=engine_cfg.stats_window)

    # -- device programs ------------------------------------------------------
    def _decode_impl(self, params, cache, pstate, last_tokens, sparams, bias,
                     nonces, pos, step, active):
        lens0 = cache["len"]
        logits, cache = self.model.decode_step(params, last_tokens, cache)
        # inactive rows (retired-but-uncommitted or empty slots) must not
        # advance their cache write offset
        cache = dict(cache)
        cache["len"] = torch.where(active, lens0 + 1, lens0)
        tokens, pstate, stats = self.decision.step(
            logits, pstate, sparams, step, active=active,
            rng_tags=(nonces, pos), logit_bias=bias)
        tokens = torch.where(active, tokens, 0)
        return tokens, cache, pstate, stats

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

    def _on_slot_free(self, slot: int, req: Request) -> None:
        """A slot gave up its claim: reset its sampling-contract row so
        nothing stale is dispatched for the slot's next occupant."""
        self._sp.reset_row(slot)

    # -- public API -----------------------------------------------------------
    @locked_api
    def submit(self, requests: List[Request]) -> None:
        if self._closed:
            raise RuntimeError("Engine is closed")
        for r in requests:
            self.scheduler.submit(r)

    @property
    def in_flight(self) -> int:
        """Dispatched-but-uncommitted iterations (0 or 1 in overlap mode)."""
        return len(self._pending)

    @locked_api
    def step(self):
        """One engine iteration. Returns the StepRecord committed this call
        (lagged by one step in overlapped mode), or {} if none was."""
        plan = self.scheduler.schedule()
        if plan.new_requests:
            self._admit(plan.new_requests)
        # refresh decode activity: a prompt's first token may already
        # satisfy the stop condition
        plan.active_slots = np.array(
            [s is not None and s.state is RequestState.RUNNING
             and not s.should_stop() for s in self.scheduler.slots])
        dispatched = bool(plan.active_slots.any())
        if dispatched:
            # host arrays are copied on upload: the engine mutates
            # _nonce/_pos/_sp after dispatch
            tokens, self.cache, self.pstate, stats = self._decode_impl(
                self.params, self.cache, self.pstate, self.last_tokens,
                self._sp.as_params(), self._sp.bias_array(),
                self._nonce.copy(), self._pos.copy(), plan.step,
                to_device(plan.active_slots, self.device))
            self.last_tokens = tokens
            self._pending.append(_Pending(
                fetch=_HostCopy(tokens, stats), step=plan.step,
                active=plan.active_slots.copy(),
                slot_request=list(plan.slot_request)))
            self._pos += plan.active_slots
        # drain: sequential mode syncs now; overlapped mode keeps exactly
        # one decode in flight so the device never waits on the host
        keep = 1 if (self.ecfg.overlap and dispatched) else 0
        rec: Optional[StepRecord] = None
        while len(self._pending) > keep:
            rec = self._drain_one()
        return rec if rec is not None else {}

    @locked_api
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
        """Commit in-flight iterations and refuse further submissions.
        Idempotent, and safe on a partially constructed engine."""
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

    def export_request(self, request_id: int):
        raise _unported("KV migration (export_request)", 9)

    def import_request(self, payload):
        raise _unported("KV migration (import_request)", 9)

    # -- commit ---------------------------------------------------------------
    def _drain_one(self) -> StepRecord:
        """Wait for the oldest pending step's tokens and commit them — the
        only place a decode iteration blocks on the device."""
        ent = self._pending.pop(0)
        toks_np, stats = ent.fetch.wait()
        now = time.perf_counter()
        self.scheduler.commit(toks_np, ent.slot_request, ent.active, now=now)
        rec = StepRecord(step=ent.step, batch=int(ent.active.sum()),
                         accept_rate=float(stats[0]),
                         alpha_mean=float(stats[1]),
                         fallback_rate=float(stats[2]),
                         queue_depth=float(len(self.scheduler.waiting)),
                         queue_delay_ms=self._queue_delay_ms())
        self.stats_log.append(rec)
        return rec

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
    def _admit(self, new_requests: List[Request]) -> None:
        """Prefill new requests (padded batch) and insert their rows into
        the batch state at their slots (in place, behind any decode still
        running on the stream)."""
        first, rows_cache, rows_pstate, rids = \
            prefill_new_rows(self, new_requests, self.scheduler.step)
        slots = to_device(np.array([r.slot for r in new_requests], np.int64),
                          self.device)
        _insert_rows(self.cache, rows_cache, slots)
        self.pstate.prompt_counts[slots] = rows_pstate.prompt_counts
        self.pstate.output_counts[slots] = rows_pstate.output_counts
        self.last_tokens = self.last_tokens.index_put((slots,), first)
        now = time.perf_counter()
        first_np = first.cpu().numpy()   # blocks on the prefill
        for i, r in enumerate(new_requests):
            self._sp.set_row(r.slot, r.sampling)
            self._nonce[r.slot] = rids[i]
            self._pos[r.slot] = 1
            r.record_token(int(first_np[i]), now)


def _insert_rows(batch_cache, rows_cache, slots) -> None:
    """Write per-row cache entries into the engine's batch cache at
    ``slots``, in place. K/V leaves are (L, B, ...) with the batch on
    axis 1; ``len`` is (B,)."""
    batch_cache["k"][:, slots] = rows_cache["k"]
    batch_cache["v"][:, slots] = rows_cache["v"]
    batch_cache["len"][slots] = rows_cache["len"]


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
        self._cached = None

    def reset_row(self, i: int) -> None:
        """Return row ``i`` to the default contract when its slot frees."""
        self.set_row(i, SamplingConfig())

    def as_params(self) -> SamplingParams:
        if self._cached is None:
            d = self.device
            self._cached = SamplingParams(
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
        return self._cached

    def bias_array(self) -> Optional[torch.Tensor]:
        """Dense (B, V) logit-bias operand, or None while no request has
        ever used logit_bias."""
        if self._bias_dense is None:
            return None
        if self._bias_cached is None:
            self._bias_cached = to_device(self._bias_dense, self.device)
        return self._bias_cached
