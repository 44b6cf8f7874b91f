"""ReplicaFleet: N engines, each on its own worker thread, bridged to
the gateway through single-owner submission queues (DESIGN.md §16).

The engines' public API is lock-serialized (``engine.locked_api``), but a
lock only makes interleaving *safe* — it does not make an engine fast
under N event-loop coroutines each trying to drive ``step()``. The fleet
therefore gives every replica the strongest ownership discipline: ONE
worker thread owns all calls into its engine (submit, step, flush,
close), and everyone else talks to that thread through a queue:

    router thread  --try_submit-->  inbox queue  -->  worker thread
    worker thread  --sink(event)-->  per-request sink (the HTTP layer
                                     bridges it onto the asyncio loop)

Tokens flow out *at commit time* through the same
:class:`~repro_torch.engine.engine.StreamCursor` that ``generate_stream``
uses, so the wire stream is the in-process stream by construction.

Backpressure is admission-time: each replica bounds its open requests
(queued + in flight) at ``capacity`` and ``try_submit`` refuses beyond
it — the router turns that refusal into HTTP 429 + Retry-After instead
of buffering unboundedly (DESIGN.md §16 backpressure contract).

Lifecycle: ``stop_accepting`` → ``drain`` (in-flight streams finish) →
``close`` (worker joined, ``engine.close()``); ``close`` is idempotent
and also safe without a prior drain (remaining committed tokens are
pumped to their sinks, open handles get an ``aborted`` error).
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch.engine.engine import GenerationEvent, StreamCursor
from repro_torch.engine.request import Request, RequestState

#: sentinel asking a replica worker to exit its loop
_STOP = object()

#: worker wake-up granularity while idle (s) — only bounds how stale the
#: idle loop's view of the stop flag can get; submissions wake it
#: immediately via the blocking queue get
_IDLE_POLL = 0.02


@dataclass
class _Work:
    """One submission crossing the bridge into a replica worker.

    ``emitted`` is the number of tokens already delivered to the sink by
    a previous replica (a prefill→decode handoff, DESIGN.md §18) — the
    receiving worker's cursor starts there so no token is re-streamed.
    ``session_id`` rides along so the handoff can honor decode-side
    session affinity."""

    request: Request
    sink: Callable[[GenerationEvent], None]
    on_done: Optional[Callable[[Request, Optional[BaseException]], None]] \
        = None
    emitted: int = 0
    session_id: Optional[str] = None


@dataclass
class _Handle:
    """Worker-side state of one open stream."""

    work: _Work
    cursor: StreamCursor = field(init=False)

    def __post_init__(self):
        self.cursor = StreamCursor(self.work.request)
        self.cursor.emitted = self.work.emitted


class Replica:
    """One engine on one worker thread behind a single-owner inbox.

    ``role`` (DESIGN.md §18): ``"both"`` (colocated default — admit and
    decode), ``"prefill"`` (admit prompts; once a request commits its
    first token, offer it to the handoff hook, which reserves a
    decode-role replica and receives the request's exported
    :class:`~repro_torch.engine.migration.KVPayload` through the inbox),
    or ``"decode"`` (never admitted to by the router; accepts migrations
    via :meth:`reserve` + :meth:`submit_reserved`). A prefill replica
    whose handoff hook finds no decode capacity keeps decoding the
    request itself and retries next loop — strict affinity can refuse a
    migration, never stall a stream."""

    def __init__(self, name: str, engine, capacity: int = 16,
                 role: str = "both"):
        assert capacity >= 1
        assert role in ("both", "prefill", "decode"), role
        self.name = name
        self.engine = engine
        self.capacity = capacity
        self.role = role
        self._handoff: Optional[Callable[[Optional[str]],
                                         Optional["Replica"]]] = None
        self._inbox: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._load = 0                 # open requests (queued + in flight)
        self._served = 0               # finished streams (stats)
        self._handed_off = 0           # streams migrated out (stats)
        self._accepting = True
        self._drained = threading.Event()
        self._drained.set()
        self._started = False
        self._closed = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"replica-{name}")

    # -- gateway-facing surface (router / event-loop threads) ---------------
    @property
    def load(self) -> int:
        with self._lock:
            return self._load

    @property
    def served(self) -> int:
        with self._lock:
            return self._served

    @property
    def handed_off(self) -> int:
        with self._lock:
            return self._handed_off

    @property
    def accepting(self) -> bool:
        with self._lock:
            return self._accepting and not self._closed

    def start(self) -> "Replica":
        if not self._started:
            self._started = True
            self._thread.start()
        return self

    def set_handoff(self, hook: Callable[[Optional[str]],
                                         Optional["Replica"]]) -> None:
        """Install the handoff policy (prefill role): called with the
        stream's session id; must RESERVE capacity on the returned decode
        replica (or return None to retry later)."""
        self._handoff = hook

    def stats(self) -> dict:
        """Router-debuggability snapshot for ``GET /v1/stats`` (§18):
        role/load/flow plus the engine's free-block and migration
        counters when it exposes them."""
        with self._lock:
            s = {"role": self.role, "load": self._load,
                 "served": self._served, "handed_off": self._handed_off,
                 "accepting": self._accepting and not self._closed}
        mig = getattr(self.engine, "migration_stats", None)
        if mig is not None:
            s.update(mig())
        return s

    def try_submit(self, request: Request,
                   sink: Callable[[GenerationEvent], None],
                   on_done=None, session_id: Optional[str] = None) -> bool:
        """Admit one request, or refuse (False) when the replica is at
        capacity or no longer accepting — the backpressure edge. Never
        blocks and never buffers beyond ``capacity``."""
        with self._lock:
            if self._closed or not self._accepting or \
                    self._load >= self.capacity:
                return False
            self._load += 1
            self._drained.clear()
        self._inbox.put(_Work(request, sink, on_done,
                              session_id=session_id))
        return True

    # -- migration edges (prefill/decode disaggregation, §18) ---------------
    def reserve(self) -> bool:
        """Atomically claim one capacity unit for an incoming migration;
        the unit is consumed by :meth:`submit_reserved` or returned by
        :meth:`unreserve`. Same admission predicate as ``try_submit``."""
        with self._lock:
            if self._closed or not self._accepting or \
                    self._load >= self.capacity:
                return False
            self._load += 1
            self._drained.clear()
        return True

    def unreserve(self) -> None:
        """Return a reservation whose migration fell through."""
        with self._lock:
            self._load -= 1
            if self._load == 0:
                self._drained.set()

    def submit_reserved(self, work: _Work, emitted: int) -> None:
        """Enqueue a migrated stream against a held reservation: the
        request arrives carrying its :class:`KVPayload` (installed by the
        engine's admission path) and the cursor resumes at ``emitted`` so
        already-streamed tokens are never re-delivered."""
        self._inbox.put(_Work(work.request, work.sink, work.on_done,
                              emitted=emitted, session_id=work.session_id))

    def stop_accepting(self) -> None:
        with self._lock:
            self._accepting = False

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every open stream finished (True) or ``timeout``
        expired (False). Callers normally ``stop_accepting`` first."""
        return self._drained.wait(timeout)

    def close(self, drain_timeout: float = 30.0) -> None:
        """Graceful shutdown: stop admissions, drain in-flight streams
        (bounded by ``drain_timeout``), stop the worker, close the
        engine. Idempotent — fleet shutdown paths double-close."""
        with self._lock:
            if self._closed:
                return
            self._accepting = False
            self._closed = True
        if self._started:
            self.drain(drain_timeout)
            self._inbox.put(_STOP)
            self._thread.join()
        self.engine.close()

    # -- worker body --------------------------------------------------------
    def _finish(self, h: _Handle, err: Optional[BaseException]) -> None:
        if h.work.on_done is not None:
            try:
                h.work.on_done(h.work.request, err)
            except Exception:
                pass                      # a sink bug must not kill the loop
        with self._lock:
            self._load -= 1
            self._served += 1
            if self._load == 0:
                self._drained.set()

    def _pump(self, handles: Dict[int, _Handle]) -> None:
        """Deliver committed-but-undelivered tokens to every open sink."""
        for rid in list(handles):
            h = handles[rid]
            try:
                for ev in h.cursor.drain():
                    h.work.sink(ev)
            except Exception as e:
                handles.pop(rid)
                self._finish(h, e)
                continue
            if h.cursor.closed:
                handles.pop(rid)
                self._finish(h, None)

    def _try_handoffs(self, handles: Dict[int, _Handle]) -> None:
        """Prefill role: offer every stream past its first committed
        token to the handoff hook. On success the request's KV is
        exported at a commit boundary and the stream (sink, cursor
        offset, session) moves to the reserved decode replica; on refusal
        (no decode capacity / strict affinity) the request simply keeps
        decoding here and is offered again next loop."""
        if self._handoff is None:
            return
        eng = self.engine
        for rid in list(handles):
            h = handles[rid]
            r = h.work.request
            if h.cursor.closed or not r.output or r.should_stop():
                continue
            if r.state is not RequestState.RUNNING:
                continue
            target = self._handoff(h.work.session_id)
            if target is None:
                continue
            try:
                payload = eng.export_request(rid)
            except (KeyError, ValueError):
                # raced a finishing/preempting flush — stays local
                target.unreserve()
                continue
            # deliver what the export flush committed before the cursor
            # offset crosses; then this worker forgets the stream without
            # counting it served (the decode side finishes it)
            try:
                for ev in h.cursor.drain():
                    h.work.sink(ev)
            except Exception as e:
                target.unreserve()
                handles.pop(rid)
                self._finish(h, e)
                continue
            handles.pop(rid)
            with self._lock:
                self._load -= 1
                self._handed_off += 1
                if self._load == 0:
                    self._drained.set()
            target.submit_reserved(h.work, h.cursor.emitted)
            assert payload is r.kv_payload   # rides inside the request

    def _loop(self) -> None:
        handles: Dict[int, _Handle] = {}
        try:
            self._loop_body(handles)
        except BaseException as e:
            # a crashed worker must abort its open streams, not strand
            # them: clients are blocked on sinks that would never fire
            with self._lock:
                self._accepting = False
            for h in list(handles.values()):
                self._finish(h, e)
            handles.clear()
            raise

    def _loop_body(self, handles: Dict[int, _Handle]) -> None:
        eng = self.engine
        stopping = False
        while True:
            busy = bool(handles) or eng.scheduler.has_work or eng.in_flight
            items = []
            try:
                if not busy:
                    items.append(self._inbox.get(timeout=_IDLE_POLL))
                while True:
                    items.append(self._inbox.get_nowait())
            except queue.Empty:
                pass
            for item in items:
                if item is _STOP:
                    stopping = True
                    continue
                h = _Handle(item)
                try:
                    eng.submit([item.request])
                except Exception as e:
                    self._finish(h, e)
                    continue
                handles[item.request.request_id] = h
            if eng.scheduler.has_work or eng.in_flight:
                eng.step()
                self._pump(handles)
                self._try_handoffs(handles)
            elif handles:
                # requests whose last token committed on the final step
                # (or that were submitted and finished instantly)
                eng.flush()
                self._pump(handles)
            if stopping and not handles:
                break
        # unclean stop (close without drain): commit what is in flight so
        # the engine's close() contract holds, deliver it, then abort any
        # stream that is still open
        eng.flush()
        self._pump(handles)
        for h in handles.values():
            self._finish(h, RuntimeError("replica shut down mid-stream"))


class ReplicaFleet:
    """The gateway's engine fleet: build/adopt N replicas, start their
    workers, and shut them down as a unit."""

    def __init__(self, engines: List, capacity: int = 16,
                 name_prefix: str = "replica",
                 roles: Optional[List[str]] = None):
        """``roles`` (optional, one per engine — DESIGN.md §18): a mix of
        ``"prefill"``/``"decode"`` entries builds a disaggregated fleet
        (a disaggregated fleet needs at least one of each); the default
        is every replica colocated (``"both"``)."""
        assert engines, "a fleet needs at least one engine"
        roles = list(roles) if roles is not None else ["both"] * len(engines)
        assert len(roles) == len(engines), "one role per engine"
        if any(r in ("prefill", "decode") for r in roles):
            assert "prefill" in roles and "decode" in roles, \
                "a disaggregated fleet needs >=1 prefill and >=1 decode " \
                "replica"
        self.replicas = [Replica(f"{name_prefix}{i}", eng, capacity,
                                 role=role)
                         for i, (eng, role) in enumerate(zip(engines, roles))]
        self._closed = False

    def __len__(self) -> int:
        return len(self.replicas)

    @property
    def disaggregated(self) -> bool:
        return any(r.role in ("prefill", "decode") for r in self.replicas)

    @property
    def prefill_replicas(self) -> List[Replica]:
        """Admission targets: prefill-role replicas (disaggregated) or
        everyone (colocated)."""
        if not self.disaggregated:
            return list(self.replicas)
        return [r for r in self.replicas if r.role == "prefill"]

    @property
    def decode_replicas(self) -> List[Replica]:
        return [r for r in self.replicas if r.role == "decode"]

    def start(self) -> "ReplicaFleet":
        for r in self.replicas:
            r.start()
        return self

    def loads(self) -> Dict[str, int]:
        return {r.name: r.load for r in self.replicas}

    def stop_accepting(self) -> None:
        for r in self.replicas:
            r.stop_accepting()

    def drain(self, timeout: float = 30.0) -> bool:
        """Stop admissions and wait for every in-flight stream to finish;
        returns False if any replica missed the deadline."""
        self.stop_accepting()
        deadline = time.monotonic() + timeout
        ok = True
        for r in self.replicas:
            ok &= r.drain(max(0.0, deadline - time.monotonic()))
        return ok

    def close(self, drain_timeout: float = 30.0) -> None:
        """Drain and close every replica (idempotent; double-closing a
        replica's engine is a no-op by the engine close contract)."""
        if self._closed:
            return
        self._closed = True
        self.stop_accepting()
        for r in self.replicas:
            r.close(drain_timeout)


__all__ = ["Replica", "ReplicaFleet"]
