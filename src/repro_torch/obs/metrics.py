"""Stdlib metrics registry with Prometheus text exposition (DESIGN.md §17).

Counters, gauges, and fixed-bucket histograms — everything the gateway's
``GET /metrics`` endpoint serves — with no dependency beyond the standard
library (the same constraint as the gateway itself: one process, stdlib
only). Instruments are get-or-create by ``(name, labels)`` so hot paths
may re-ask the registry for a labeled series without allocation churn;
each instrument carries its own lock (engine thread, pool workers, and
the gateway loop all write).

The exposition format is the Prometheus text format 0.0.4: ``# HELP`` /
``# TYPE`` per family, ``name{label="value"} v`` samples, histograms as
cumulative ``_bucket{le=...}`` plus ``_sum`` / ``_count``.
:func:`render_registries` merges several registries into one page with
per-registry injected labels — the gateway renders its own registry plus
every replica engine's registry tagged ``replica="..."``, each family's
HELP/TYPE emitted once.
"""
from __future__ import annotations

import math
import re
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: default latency buckets (milliseconds) — spans the sub-ms pool
#: decomposition up through multi-second queueing tails.
DEFAULT_MS_BUCKETS: Tuple[float, ...] = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
    500.0, 1000.0, 2500.0, 5000.0)

LabelPairs = Tuple[Tuple[str, str], ...]


def _escape(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"') \
                .replace("\n", "\\n")


def _fmt_labels(labels: LabelPairs) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in labels)
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(float(v))


class Counter:
    """Monotonically increasing sample."""

    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counters only go up, got inc({amount!r})")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value

    def samples(self, name: str, labels: LabelPairs) -> List[str]:
        return [f"{name}{_fmt_labels(labels)} {_fmt_value(self._value)}"]


class Gauge:
    """Settable sample (queue depth, pool width, placement flag)."""

    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        return self._value

    def samples(self, name: str, labels: LabelPairs) -> List[str]:
        return [f"{name}{_fmt_labels(labels)} {_fmt_value(self._value)}"]


class Histogram:
    """Fixed-bucket histogram (Prometheus cumulative exposition).

    ``buckets`` are the finite upper bounds; a ``+Inf`` bucket is
    implicit. Non-finite observations are dropped — NaN stats ("no
    sample", §13) must not poison ``_sum``.
    """

    __slots__ = ("_lock", "uppers", "_counts", "_sum", "_count")

    def __init__(self, buckets: Sequence[float] = DEFAULT_MS_BUCKETS):
        uppers = tuple(sorted(float(b) for b in buckets))
        if not uppers or any(not math.isfinite(b) for b in uppers):
            raise ValueError(f"buckets must be finite and non-empty, "
                             f"got {buckets!r}")
        if len(set(uppers)) != len(uppers):
            raise ValueError(f"duplicate bucket bounds: {buckets!r}")
        self.uppers = uppers
        self._lock = threading.Lock()
        self._counts = [0] * (len(uppers) + 1)      # + the +Inf bucket
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        if not math.isfinite(v):
            return
        i = 0
        for i, ub in enumerate(self.uppers):
            if v <= ub:
                break
        else:
            i = len(self.uppers)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def samples(self, name: str, labels: LabelPairs) -> List[str]:
        out: List[str] = []
        cum = 0
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        for ub, c in zip(self.uppers, counts):
            cum += c
            le = (("le", format(ub, "g")),)
            out.append(f"{name}_bucket{_fmt_labels(labels + le)} {cum}")
        out.append(f"{name}_bucket{_fmt_labels(labels + (('le', '+Inf'),))} "
                   f"{total}")
        out.append(f"{name}_sum{_fmt_labels(labels)} {_fmt_value(s)}")
        out.append(f"{name}_count{_fmt_labels(labels)} {total}")
        return out


_TYPES = {Counter: "counter", Gauge: "gauge", Histogram: "histogram"}


class MetricsRegistry:
    """Get-or-create instrument store keyed by ``(name, labels)``.

    One family (shared name) may carry many label sets but exactly one
    instrument type and help string — re-registering with a conflicting
    type fails loudly at the call site, not at scrape time.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: Dict[str, Tuple[type, str]] = {}
        self._series: Dict[Tuple[str, LabelPairs], object] = {}

    def _get(self, cls: type, name: str, help_: str, labels: Dict[str, str],
             factory) -> object:
        if not _NAME_RE.match(name):
            raise ValueError(f"bad metric name {name!r}")
        pairs: LabelPairs = tuple(sorted(
            (str(k), str(v)) for k, v in labels.items()))
        for k, _ in pairs:
            if not _LABEL_RE.match(k):
                raise ValueError(f"bad label name {k!r} on {name!r}")
        key = (name, pairs)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                self._families[name] = (cls, help_)
            elif fam[0] is not cls:
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{_TYPES[fam[0]]}, asked for {_TYPES[cls]}")
            inst = self._series.get(key)
            if inst is None:
                inst = self._series[key] = factory()
            return inst

    def counter(self, name: str, help_: str = "", **labels) -> Counter:
        return self._get(Counter, name, help_, labels, Counter)

    def gauge(self, name: str, help_: str = "", **labels) -> Gauge:
        return self._get(Gauge, name, help_, labels, Gauge)

    def histogram(self, name: str, help_: str = "",
                  buckets: Sequence[float] = DEFAULT_MS_BUCKETS,
                  **labels) -> Histogram:
        return self._get(Histogram, name, help_, labels,
                         lambda: Histogram(buckets))

    def collect(self) -> Dict[str, Tuple[str, str,
                                         List[Tuple[LabelPairs, object]]]]:
        """``{family: (type, help, [(labels, instrument), ...])}`` with
        label sets in sorted order (stable exposition)."""
        with self._lock:
            fams = dict(self._families)
            series = dict(self._series)
        out: Dict[str, Tuple[str, str, List[Tuple[LabelPairs, object]]]] = {}
        for name, (cls, help_) in sorted(fams.items()):
            rows = sorted(((pairs, inst) for (n, pairs), inst
                           in series.items() if n == name),
                          key=lambda kv: kv[0])
            out[name] = (_TYPES[cls], help_, rows)
        return out

    def render(self, extra_labels: Optional[Dict[str, str]] = None) -> str:
        return render_registries([(extra_labels or {}, self)])


def render_registries(
        registries: Iterable[Tuple[Dict[str, str], MetricsRegistry]]) -> str:
    """Prometheus text page over several registries, each with injected
    labels; families sharing a name across registries are merged under
    one HELP/TYPE header (they must agree on the instrument type)."""
    merged: Dict[str, Tuple[str, str, List[str]]] = {}
    for extra, reg in registries:
        inject: LabelPairs = tuple(sorted(
            (str(k), str(v)) for k, v in (extra or {}).items()))
        for name, (typ, help_, rows) in reg.collect().items():
            if name in merged and merged[name][0] != typ:
                raise ValueError(
                    f"metric {name!r} is a {merged[name][0]} in one "
                    f"registry and a {typ} in another")
            lines = merged.setdefault(name, (typ, help_, []))[2]
            for pairs, inst in rows:
                lines.extend(inst.samples(name, inject + pairs))
    out: List[str] = []
    for name in sorted(merged):
        typ, help_, lines = merged[name]
        if help_:
            out.append(f"# HELP {name} {_escape(help_)}")
        out.append(f"# TYPE {name} {typ}")
        out.extend(lines)
    return "\n".join(out) + "\n" if out else ""


__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "render_registries", "DEFAULT_MS_BUCKETS"]
