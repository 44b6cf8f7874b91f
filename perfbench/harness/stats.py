"""The arithmetic of the end-to-end metrics and of device time, over
plain numbers: percentiles over every sample, rates over a window, the
union of device intervals and the gaps between them."""
from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple


def percentile(xs: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) of every sample, linear between the
    two nearest ranks (numpy's default)."""
    if not xs:
        raise ValueError("percentile of no samples")
    s = sorted(xs)
    pos = (len(s) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def count_in(times: Iterable[float], t0: float, t1: float) -> int:
    return sum(1 for t in times if t0 <= t < t1)


def merge(intervals: Iterable[Tuple[float, float]]
          ) -> List[Tuple[float, float]]:
    """The union of [start, end) intervals, sorted and disjoint."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(intervals: Iterable[Tuple[float, float]], t0: float, t1: float
         ) -> List[Tuple[float, float]]:
    return [(max(a, t0), min(b, t1)) for a, b in intervals
            if b > t0 and a < t1]


def busy(intervals: Iterable[Tuple[float, float]], t0: float, t1: float
         ) -> float:
    """Seconds of [t0, t1) covered by at least one interval."""
    return sum(b - a for a, b in merge(clip(intervals, t0, t1)))


def gaps(intervals: Iterable[Tuple[float, float]], t0: float, t1: float
         ) -> List[Tuple[float, float]]:
    """The idle stretches of [t0, t1) between the merged intervals."""
    out, t = [], t0
    for a, b in merge(clip(intervals, t0, t1)):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if t < t1:
        out.append((t, t1))
    return out
