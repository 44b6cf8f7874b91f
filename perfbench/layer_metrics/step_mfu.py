"""Model step: the model FLOPs of the tokens processed in the window
outside the profiler's stretch (prompts prefilled and tokens decoded;
2 x active weights a token plus attention over its context,
``frozen/arith.py``) over that stretch, as a share of the card's bf16
dense peak, %."""
from perfbench.frozen import arith


def read(name, run):
    try:
        peak = arith.peaks(run.device_name)["bf16_flops"]
    except KeyError:
        return None
    cfg = run.cell.config
    quiet = run.quiet()
    flops = 0.0
    for s in run.log.served:
        r = s.request
        P = len(r.prompt)
        for j, t in enumerate(r.token_times):
            if any(a <= t < b for a, b in quiet):
                flops += arith.prompt_flops(cfg, P) if j == 0 else \
                    arith.token_flops(cfg, P + j)
    return flops / run.quiet_s / peak * 100 if flops else None
