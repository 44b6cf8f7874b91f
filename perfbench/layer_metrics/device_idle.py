"""Device: the share of the profiled stretch in which no kernel, copy or
memset ran on the card, % (the union of the profiler's device
intervals)."""
from perfbench.harness import stats


def read(name, run):
    tr = run.trace
    if tr is None or not tr.ops:
        return None
    busy = stats.busy(tr.intervals(), tr.t0, tr.t1)
    return (1.0 - busy / (tr.t1 - tr.t0)) * 100
