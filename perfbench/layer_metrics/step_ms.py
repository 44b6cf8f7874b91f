"""Engine loop: wall milliseconds a committed step: the window, less
the profiler's stretch, over the steps the engine committed in it
(``Engine.step``'s records)."""


def read(name, run):
    n = len(run.quiet_commits())
    return run.quiet_s / n * 1e3 if n else None
