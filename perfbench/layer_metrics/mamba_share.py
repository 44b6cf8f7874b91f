"""Model step: the Mamba2 mixers' share of the window on the card, %:
the device time (``device_ms``) of the engine's ``mamba`` spans (each
Mamba2 layer's mixer, from its input projection to its output projection
and its state written back) that start in the window outside the
profiler's stretch, over that stretch. It follows the mixers whatever
kernels implement them; a program without such spans reads nothing."""


def read(name, run):
    xs = [dict(e.args).get("device_ms") for e in run.quiet_spans("mamba")]
    xs = [x for x in xs if x is not None]
    return sum(xs) * 1e-3 / run.quiet_s * 100 if xs else None
