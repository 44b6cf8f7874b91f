"""Host sampler pool: the workers' CPU sampling a step, ms (the mean of
``StepRecord.sampler_ms`` over the host-sampled steps committed in the
window outside the profiler's stretch)."""


def read(name, run):
    xs = [r.sampler_ms for r in run.quiet_commits()
          if r.sampler_ms is not None]
    return sum(xs) / len(xs) if xs else None
