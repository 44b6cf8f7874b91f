"""Model step: the Mamba2 mixer's share of its HBM roofline in decode, %.

For the engine's ``mamba`` spans with ``program`` "decode" that start in
the window outside the profiler's stretch: the least bytes of each call
(:func:`decode_bytes`, from the cell's configuration) at the card's HBM
rate, over the spans' device time (``device_ms``). The bytes are the
same whatever implements the mixer, so a fused state update is judged by
the same work; a program without such spans reads nothing."""
from perfbench.frozen import arith

_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def decode_bytes(cfg: dict, rows: int) -> int:
    """The least HBM traffic of one Mamba2 mixer's decode call over
    ``rows`` rows: its input projection, conv (taps and bias) and output
    projection weights read once, and for each row its float32 SSM state
    read and written and its conv carry (K - 1 inputs of x, B and C, in
    the model's dtype) read and written."""
    w = _BYTES[cfg["dtype"]]
    d, N, K = cfg["hidden_size"], cfg["mamba_d_state"], cfg["mamba_d_conv"]
    inner = cfg["mamba_expand"] * d
    H, P = cfg["mamba_n_heads"], cfg["mamba_d_head"]
    C = inner + 2 * N
    weights = (d * (2 * inner + 2 * N + H) + (K + 1) * C + inner * d) * w
    per_row = 2 * H * P * N * 4 + 2 * (K - 1) * C * w
    return weights + rows * per_row


def read(name, run):
    try:
        bw = arith.peaks(run.device_name)["hbm_bytes_per_s"]
    except KeyError:
        return None
    calls = [a for a in (dict(e.args) for e in run.quiet_spans("mamba"))
             if a.get("program") == "decode" and "device_ms" in a]
    if not calls:
        return None
    least = sum(decode_bytes(run.cell.config, a["rows"]) for a in calls)
    took = sum(a["device_ms"] for a in calls) * 1e-3
    return least / bw / took * 100
