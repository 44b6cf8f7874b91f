"""Host sampler pool: the engine's block on the pool's ticket a step, ms
(``StepRecord.stall_ms`` summed over the steps committed in the window
outside the profiler's stretch, over their count)."""


def read(name, run):
    recs = run.quiet_commits()
    xs = [r.stall_ms for r in recs if r.stall_ms is not None]
    return sum(xs) / len(recs) if xs else None
