"""Model step: device kernels a committed step, in the profiled stretch
of the window (``torch.profiler``'s kernel records over the steps the
engine committed in the stretch)."""


def read(name, run):
    tr = run.trace
    if tr is None:
        return None
    steps = len(run.commits_in(tr.t0, tr.t1))
    return len(tr.kernels) / steps if steps and tr.kernels else None
