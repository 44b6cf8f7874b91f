"""Model step: the MoE routing's share of the window on the card, %: the
device time (``device_ms``) of the engine's ``moe_route`` spans (each
layer's router, top-k and slot ranks) that start in the window outside
the profiler's stretch, over that stretch. It follows the routing
whatever kernels implement it."""


def read(name, run):
    xs = [dict(e.args).get("device_ms") for e in run.quiet_spans("moe_route")]
    xs = [x for x in xs if x is not None]
    return sum(xs) * 1e-3 / run.quiet_s * 100 if xs else None
