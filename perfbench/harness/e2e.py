"""End-to-end metrics by name, over the load loop's log and the requests.

* ``tokens_per_s``: output tokens committed in the window / the window;
* ``ttft_p<q>_ms``: the q-th percentile, over every request due in the
  window, of its first token's commit minus its due time;
* ``itl_p<q>_ms``: the q-th percentile over every gap between two
  committed tokens of every request due in the window;
* ``setup_s``: process start to the traffic's start (taken by run.py).
"""
from __future__ import annotations

import re
from typing import List

from . import stats


def window_requests(log) -> List:
    return [s for s in log.served if log.ws <= s.due < log.we]


def value(name: str, log, setup_s: float) -> float:
    if name == "setup_s":
        return setup_s
    if name == "tokens_per_s":
        n = sum(stats.count_in(s.request.token_times, log.ws, log.we)
                for s in log.served)
        return n / (log.we - log.ws)
    m = re.fullmatch(r"(ttft|itl)_p(\d+)_ms", name)
    if m is None:
        raise KeyError(f"no end-to-end metric {name!r}")
    q = float(m.group(2))
    reqs = window_requests(log)
    if m.group(1) == "ttft":
        xs = [s.request.first_token_time - s.due for s in reqs
              if s.request.first_token_time is not None]
    else:
        xs = [b - a for s in reqs for a, b in zip(
            s.request.token_times, s.request.token_times[1:])]
    return stats.percentile(xs, q) * 1e3
