"""Engine loop: the share of the window spent in admission prefills, %
(the engine's ``prefill`` spans that start in the window outside the
profiler's stretch, over that stretch of the window)."""


def read(name, run):
    xs = [e.dur for e in run.quiet_spans("prefill")]
    return sum(xs) / run.quiet_s * 100 if xs else None
