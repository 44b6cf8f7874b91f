"""Engine loop: the mean host time of a decode step's dispatch, ms (the
engine's ``dispatch`` spans in the window outside the profiler's
stretch: the host enqueueing the forward and the decision, or the
forward and the pool's ticket)."""


def read(name, run):
    xs = [e.dur for e in run.quiet_spans("dispatch")]
    return sum(xs) / len(xs) * 1e3 if xs else None
