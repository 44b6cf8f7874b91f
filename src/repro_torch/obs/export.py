"""Chrome trace-event / Perfetto JSON export of the flight recorder
(DESIGN.md §17).

The format is the Trace Event Format's JSON-array flavor — loadable by
``chrome://tracing`` and https://ui.perfetto.dev — so the paper's timing
claims become visually inspectable timelines: per-(stage, microbatch)
spans stack per stage track, the pool workers' ``host_sample`` spans sit
on their own thread tracks overlapping the next forward (Eq. 4's
overlap), and ``pool_stall`` spans show exactly when the pool missed the
pipeline's slack.

Mapping: each (process_name, tracer) source becomes one ``pid``; each
distinct span ``track`` within it becomes a ``tid`` with a
``thread_name`` metadata event; spans are ``ph="X"`` complete events
with microsecond ``ts``/``dur``, instants are ``ph="i"`` with thread
scope. Every event carries the ``ph`` / ``ts`` / ``pid`` / ``tid`` keys
the viewers require. Sources must share one clock (``perf_counter`` —
the repo-wide discipline) since the viewer merges on raw timestamps.
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Sequence, Tuple, Union

from repro_torch.obs.tracer import SpanEvent, StepTracer

Source = Tuple[str, Union[StepTracer, Sequence[SpanEvent]]]


def chrome_trace_events(sources: Iterable[Source]) -> List[dict]:
    """Flatten (process_name, tracer-or-events) sources into Chrome
    trace-event dicts (metadata first, then events in time order)."""
    out: List[dict] = []
    # source order is the callers' (gateway first, then replicas): each
    # becomes one pid, so the viewer groups rows per process in that order
    for pid, (pname, src) in enumerate(list(sources), start=1):
        evs = src.events() if isinstance(src, StepTracer) else list(src)
        evs = sorted(evs, key=lambda e: (e.ts, e.dur))
        out.append({"ph": "M", "name": "process_name", "pid": pid,
                    "tid": 0, "ts": 0, "args": {"name": pname}})
        tids: Dict[str, int] = {}
        body: List[dict] = []
        for e in evs:
            tid = tids.get(e.track)
            if tid is None:
                tid = tids[e.track] = len(tids) + 1
            rec = {"name": e.name, "cat": e.kind, "ph": e.ph,
                   "ts": round(e.ts * 1e6, 3), "pid": pid, "tid": tid,
                   "args": dict(e.args)}
            if e.ph == "X":
                rec["dur"] = round(e.dur * 1e6, 3)
            else:
                rec["s"] = "t"      # thread-scoped instant
            body.append(rec)
        for track, tid in tids.items():
            out.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": tid, "ts": 0, "args": {"name": track}})
        out.extend(body)
    return out


def chrome_trace(sources: Iterable[Source]) -> dict:
    """The JSON-object flavor: ``{"traceEvents": [...]}`` plus the
    display unit hint Perfetto honors."""
    return {"traceEvents": chrome_trace_events(sources),
            "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, sources: Iterable[Source]) -> int:
    """Serialize :func:`chrome_trace` to ``path``; returns the number of
    trace events written (metadata included)."""
    doc = chrome_trace(sources)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    return len(doc["traceEvents"])


__all__ = ["chrome_trace_events", "chrome_trace", "write_chrome_trace"]
