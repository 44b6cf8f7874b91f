"""Engine loop: the median admission prefill, ms (the engine's
``prefill`` spans in the window outside the profiler's stretch: prefill
and first draw, to the tokens on the host)."""
import statistics


def read(name, run):
    xs = [e.dur for e in run.quiet_spans("prefill")]
    return statistics.median(xs) * 1e3 if xs else None
