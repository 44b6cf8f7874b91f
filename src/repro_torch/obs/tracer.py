"""Span-based step tracer + bounded flight recorder (DESIGN.md §17).

One tracer per engine (plus one on the gateway) records *typed spans* on
a single monotonic clock — ``time.perf_counter``, the clock every other
timestamp in the repo (request arrivals, stage busy times, pool
fetch/sample splits) is already taken on — into a ``deque(maxlen=N)``
ring buffer: a flight recorder that always holds the most recent window
and never grows, so it can stay attached to a long-lived gateway replica.

Span taxonomy (:data:`SPAN_KINDS`): the timing decomposition the paper's
argument is made of, one kind per seam —

    ``prefill``       admission prefill program (both engines)
    ``forward``       decode forward, dispatch → host materialization
    ``stage``         one (stage, microbatch) pipeline forward (kept in
                      the taxonomy for the pipeline engine)
    ``d2h_transfer``  a pool worker's wait on the logits' copy to pinned
                      host memory (in-flight compute + D2H copy)
    ``host_sample``   a pool worker's CPU sampling, fetch excluded
    ``pool_stall``    the engine blocking on a sampler-pool ticket —
                      the paper's "pool too slow for the slack"
    ``commit``        scheduler.commit of a step's tokens
    ``queue_wait``    a request's arrival → admission wait
    ``decision``      a controller action (instant event, §15)
    ``request``       one request's wire-level life on the gateway
    ``kv_migrate``    one migration's export gather or import scatter
                      (prefill/decode disaggregation, §18)
    ``handoff_wait``  export stamp → import install of one migrating
                      request — the KV's time in flight between engines
    ``dispatch``      the host enqueueing one decode step: the forward
                      and the decision (device placement) or the forward
                      and the pool's ticket (host placement); ``step``,
                      ``rows`` (the active rows), ``graph`` (1 where every
                      program of the step was a CUDA graph's replay,
                      ``engine/step_graph.py``); device-timed
    ``fetch_wait``    the host blocking on a device result's copy at the
                      drain (the step's tokens, a chunk's first tokens);
                      ``step``
    ``device_sample`` one call of the device decision plane; ``program``
                      (``decode`` | ``chunk`` | ``prefill``), ``rows``
                      (the rows it decides), ``step``; device-timed,
                      inside ``dispatch`` or ``prefill``
    ``moe_route``     an MoE layer's router, top-k and slot ranks (not
                      the scatter, the experts or the combine); ``pairs``
                      (tokens x k); device-timed, recorded from
                      ``models/`` through :func:`current` (a decode
                      step replayed as CUDA graphs records it between
                      the graphs' replays)
    ``mamba``         a typed stack's Mamba2 mixer, from ``in_proj`` to
                      ``out_proj`` and its state written back; ``layer``,
                      ``rows`` (the rows the call computes: every slot in
                      a decode step), ``tokens`` (rows x positions),
                      ``program`` (``prefill`` | ``decode`` | ``train``);
                      device-timed, through :func:`current` as
                      ``moe_route``

Device-timed spans (``span(..., device=d)`` with a CUDA ``d``) also
record a ``torch.cuda.Event`` pair on the device's current stream at
entry and exit; their ``args`` gain ``device_ms``, the events' elapsed
time: how long the stream took from the span's first enqueued op to its
last, waits for the host's launches included. It is resolved when the
events are read (:meth:`StepTracer.events`) and only once the end event
has completed; a read before that leaves it out and never blocks. On
the CPU a device-timed span is a plain host span.

Threading: the engine thread, every pool worker thread, and the gateway
loop record into the same tracer. ``deque.append`` is atomic under the
GIL, so recording needs no lock; each event carries a ``track`` (default:
the recording thread's name) that becomes its own timeline row in the
Chrome-trace export — overlap between the pool workers' ``host_sample``
spans and the engine track's next ``forward``/``stage`` span is the
paper's Eq. 4 claim, made visually inspectable.

Overhead discipline: a disabled tracer's :meth:`StepTracer.span` returns
one shared no-op context manager (no allocation) and ``add``/``instant``
return immediately; instrumentation sites that build f-string names
guard on :attr:`StepTracer.enabled` so a production engine pays a single
attribute check per site.

Code that is handed no tracer (the model's functional forward) records
into :func:`current`: the tracer an engine installed (:func:`use`) for
the step this thread is running, :data:`NULL_TRACER` otherwise.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Callable, Iterable, List, NamedTuple, Optional, Tuple

#: the typed span taxonomy (DESIGN.md §17) — unknown kinds are rejected
#: at record time so a typo'd instrumentation site fails loudly in tests,
#: not silently as an un-filterable category.
SPAN_KINDS = frozenset({
    "prefill", "forward", "stage", "d2h_transfer", "host_sample",
    "pool_stall", "commit", "queue_wait", "decision", "request",
    "kv_migrate", "handoff_wait", "dispatch", "fetch_wait",
    "device_sample", "moe_route", "mamba",
})


class SpanEvent(NamedTuple):
    """One recorded span (``ph="X"``) or instant event (``ph="i"``).
    Timestamps are ``time.perf_counter`` seconds; ``args`` is a sorted
    tuple of (key, value) pairs so events stay hashable/immutable."""

    kind: str                       # SPAN_KINDS entry (Chrome trace `cat`)
    name: str                       # display name (falls back to kind)
    ph: str                         # "X" complete | "i" instant
    ts: float                       # start, perf_counter seconds
    dur: float                      # seconds (0.0 for instants)
    track: str                      # timeline row (thread / stage / role)
    args: Tuple[Tuple[str, object], ...] = ()

    @property
    def end(self) -> float:
        return self.ts + self.dur


class _NullSpan:
    """Shared no-op context manager — the disabled tracer's entire cost."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **args) -> None:
        pass


NULL_SPAN = _NullSpan()


class _Span:
    """Live span context manager: stamps entry/exit on the tracer's clock
    and records on exit (so nested spans land after their parents start
    and strictly inside them — one clock, no cross-clock skew)."""

    __slots__ = ("_tr", "_kind", "_name", "_track", "_args", "_t0")

    def __init__(self, tracer: "StepTracer", kind: str, name: Optional[str],
                 track: Optional[str], args: dict):
        self._tr = tracer
        self._kind = kind
        self._name = name
        self._track = track
        self._args = args

    def __enter__(self) -> "_Span":
        self._t0 = self._tr.clock()
        return self

    def __exit__(self, *exc) -> bool:
        tr = self._tr
        tr.add(self._kind, self._t0, tr.clock(), name=self._name,
               track=self._track, **self._args)
        return False

    def set(self, **args) -> None:
        """Add ``args`` to the span's, from inside its body (a value
        known only once the body has run)."""
        self._args.update(args)


class _DeviceSpan(_Span):
    """A span that also times its body on the device: a CUDA event pair
    on the stream that was current at entry."""

    __slots__ = ("_device", "_stream", "_start")

    def __init__(self, tracer: "StepTracer", kind: str, name: Optional[str],
                 track: Optional[str], args: dict, device):
        super().__init__(tracer, kind, name, track, args)
        self._device = device

    def __enter__(self) -> "_DeviceSpan":
        import torch
        self._stream = torch.cuda.current_stream(self._device)
        self._start = torch.cuda.Event(enable_timing=True)
        self._start.record(self._stream)
        self._t0 = self._tr.clock()
        return self

    def __exit__(self, *exc) -> bool:
        import torch
        end = torch.cuda.Event(enable_timing=True)
        end.record(self._stream)
        tr = self._tr
        tr._record_timed(self._kind, self._name, self._t0, tr.clock(),
                         self._track, self._args, self._start, end)
        return False


class _Timed:
    """A device-timed span in the ring: its host event, and its CUDA
    events until the end event has completed."""

    __slots__ = ("event", "marks")

    def __init__(self, event: SpanEvent, marks):
        self.event = event
        self.marks = marks

    def read(self) -> SpanEvent:
        """The event, with ``device_ms`` once the stream has passed the
        end event (``query`` never blocks)."""
        marks = self.marks
        if marks is not None and marks[1].query():
            ms = float(marks[0].elapsed_time(marks[1]))
            self.event = self.event._replace(args=tuple(sorted(
                self.event.args + (("device_ms", ms),))))
            self.marks = None
        return self.event


class StepTracer:
    """Flight recorder of :class:`SpanEvent` items in a bounded ring
    buffer (``capacity`` most recent events; oldest evicted first).

    ``enabled=False`` (the engines' default) makes every record path a
    near-free early return; flip it on per run (``serve.py --trace-out``)
    or per instance (the obs test suite). ``clock`` is injectable for
    tests but must be shared by every tracer whose events are exported
    together — the Chrome trace merges sources on raw timestamps.
    """

    def __init__(self, capacity: int = 16384, enabled: bool = True,
                 clock: Callable[[], float] = time.perf_counter):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.clock = clock
        self._enabled = bool(enabled)
        self._buf: deque = deque(maxlen=self.capacity)

    # -- switches -------------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    # -- recording ------------------------------------------------------------
    def span(self, kind: str, name: Optional[str] = None,
             track: Optional[str] = None, device=None, **args):
        """Context manager timing its body; disabled tracers return the
        shared :data:`NULL_SPAN` (zero allocation). ``device``: the
        ``torch.device`` the body enqueues its work on; a CUDA device
        times the body on the device too (``device_ms``)."""
        if not self._enabled:
            return NULL_SPAN
        if device is not None and device.type == "cuda":
            return _DeviceSpan(self, kind, name, track, args, device)
        return _Span(self, kind, name, track, args)

    def add(self, kind: str, t0: float, t1: float,
            name: Optional[str] = None, track: Optional[str] = None,
            **args) -> None:
        """Record a span from explicit clock stamps — the path for sites
        that already measured (pool workers' fetch/sample split, stage
        busy times, request arrival→admission waits)."""
        if not self._enabled:
            return
        self._record(kind, name, "X", t0, max(0.0, t1 - t0), track, args)

    def instant(self, kind: str, name: Optional[str] = None,
                track: Optional[str] = None, **args) -> None:
        """Record a zero-duration marker (controller decisions)."""
        if not self._enabled:
            return
        self._record(kind, name, "i", self.clock(), 0.0, track, args)

    def _record(self, kind: str, name: Optional[str], ph: str, ts: float,
                dur: float, track: Optional[str], args: dict) -> None:
        # deque.append with maxlen is atomic under the GIL: engine thread,
        # pool workers, and the gateway loop record without a lock
        self._buf.append(self._event(kind, name, ph, ts, dur, track, args))

    def _record_timed(self, kind: str, name: Optional[str], t0: float,
                      t1: float, track: Optional[str], args: dict,
                      start, end) -> None:
        """Record a device-timed span; ``device_ms`` is read later."""
        self._buf.append(_Timed(self._event(
            kind, name, "X", t0, max(0.0, t1 - t0), track, args),
            (start, end)))

    @staticmethod
    def _event(kind: str, name: Optional[str], ph: str, ts: float,
               dur: float, track: Optional[str], args: dict) -> SpanEvent:
        if kind not in SPAN_KINDS:
            raise ValueError(f"unknown span kind {kind!r}; taxonomy: "
                             f"{sorted(SPAN_KINDS)} (DESIGN.md §17)")
        if track is None:
            track = threading.current_thread().name
        return SpanEvent(kind=kind, name=name or kind, ph=ph, ts=float(ts),
                         dur=float(dur), track=track,
                         args=tuple(sorted(args.items())))

    # -- reading --------------------------------------------------------------
    def events(self) -> List[SpanEvent]:
        """Snapshot of the ring buffer, oldest first; a device-timed span
        carries ``device_ms`` once its end event has completed."""
        return [e if type(e) is SpanEvent else e.read()
                for e in list(self._buf)]

    def clear(self) -> None:
        self._buf.clear()

    def __len__(self) -> int:
        return len(self._buf)


#: shared disabled tracer — the default wiring for components that accept
#: a tracer but were constructed without one (e.g. a bare HostSamplerPool).
#: Never enable it: every un-wired component in the process shares it.
NULL_TRACER = StepTracer(capacity=1, enabled=False)


_CURRENT = threading.local()


def current() -> StepTracer:
    """The tracer installed for this thread (:func:`use`), else
    :data:`NULL_TRACER`: the seam through which code that is handed no
    tracer (``models/``) records into the engine's."""
    return getattr(_CURRENT, "tracer", NULL_TRACER)


@contextlib.contextmanager
def use(tracer: StepTracer):
    """Install ``tracer`` as this thread's :func:`current` for the body;
    the previous one is restored on exit, an exception's included."""
    prev = current()
    _CURRENT.tracer = tracer
    try:
        yield tracer
    finally:
        _CURRENT.tracer = prev


def merge_events(sources: Iterable[StepTracer]) -> List[SpanEvent]:
    """Events from several tracers on one clock, sorted by start time."""
    out: List[SpanEvent] = []
    for tr in sources:
        out.extend(tr.events())
    out.sort(key=lambda e: e.ts)
    return out


__all__ = ["SPAN_KINDS", "SpanEvent", "StepTracer", "NULL_TRACER",
           "NULL_SPAN", "merge_events", "current", "use"]
