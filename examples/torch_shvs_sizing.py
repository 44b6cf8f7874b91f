"""SHVS hot-vocab sizing walkthrough on the PyTorch port (paper §5.4 /
Fig. 11–12; the twin of ``examples/shvs_sizing.py``): measure the affine
hot-path cost, the ᾱ(H) hit-ratio curve, fit the sizing model, and compare
predicted H* with the measured optimum.

    PYTHONPATH=src python examples/torch_shvs_sizing.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.config import SamplingConfig
from repro_torch.core.hot_vocab import alpha_bar, zipf_probs
from repro_torch.core.sampling import SamplingParams
from repro_torch.core.shvs import make_hot_set, shvs_sample
from repro_torch.core.sizing import SizingModel
from repro_torch.device import resolve_device


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measure_hot_path(V, H, dev, B=32, iters=20):
    """Wall-clock per-sequence time of the SHVS fast path at hot size H."""
    rng = np.random.default_rng(0)
    z = torch.as_tensor(rng.normal(0, 2, (B, V)).astype(np.float32),
                        device=dev)
    hot = make_hot_set(torch.arange(H, dtype=torch.int32), V, device=dev)
    params = SamplingParams.broadcast(B, SamplingConfig(temperature=0.9,
                                                        top_k=40),
                                      device=dev)
    u = torch.as_tensor(rng.random((B, 3), dtype=np.float32), device=dev)
    f = lambda z: shvs_sample(z, params, hot, u[:, 0], u[:, 1], u[:, 2],
                              k_cap=min(256, H)).tokens
    f(z)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        f(z)
    _sync(dev)
    return (time.perf_counter() - t0) / (iters * B)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=20,
                    help="timed calls per hot size")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    V = 32_768
    # hit-ratio curve from a synthetic Zipf "trace" (model-dependent, §5.4)
    p = zipf_probs(V, s=1.05, permute=False)
    rows = np.tile(p, (16, 1))
    hs = np.unique(np.geomspace(64, V, 24).astype(int))
    a = alpha_bar(rows, hs, counts=p)
    print("alpha(H):", [f"{h}:{v:.3f}" for h, v in zip(hs[::6], a[::6])])

    cost_hs = [256, 1024, 4096, 8192, 16384]
    times = [measure_hot_path(V, h, dev, iters=args.iters) for h in cost_hs]
    model = SizingModel.from_measurements(V, cost_hs, times, hs, a)
    print(f"affine fit: c0={model.c0:.3e}s  c={model.c:.3e}s/token")
    h_star = model.optimal_h()
    grid = np.unique(np.geomspace(64, V, 40).astype(int))
    f_vals = model.expected_cost(grid)
    h_emp = int(grid[np.argmin(f_vals)])
    print(f"H* (first-order condition) = {h_star}")
    print(f"H  (grid argmin of F)      = {h_emp}")
    print(f"F(H*)={model.expected_cost(h_star):.3e}s  "
          f"F(V)={model.expected_cost(V):.3e}s  "
          f"speedup at H* vs full: {model.expected_cost(V) / model.expected_cost(h_star):.2f}x")


if __name__ == "__main__":
    main()
