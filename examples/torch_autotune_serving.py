"""Online hot-vocab autotuning during serving on the PyTorch port (paper
§9 future work (i); the twin of ``examples/autotune_serving.py``).

The engine starts with a deliberately mis-sized hot set; the controller
observes the live hot-mass (ᾱ) stream from the decision plane, fits the
Zipf-tail curve, re-solves the Eq. 12 sizing condition, and resizes H —
all while serving stays distributionally exact (rejection/fallback
correctness is H-independent).

    PYTHONPATH=src python examples/torch_autotune_serving.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.config import SamplingConfig, SHVSConfig, get_arch
from repro_torch.core.hot_vocab import counts_from_trace, synthetic_trace
from repro_torch.device import resolve_device
from repro_torch.engine import Engine, Request
from repro_torch.engine.engine import EngineConfig
from repro_torch.models.model import Model


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=24)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_arch("tinyllama-1.1b").reduced()
    params = Model(cfg).init(seed=0, device=dev)
    trace = synthetic_trace(cfg.vocab_size, 50_000, s=1.2)
    counts = counts_from_trace(trace, cfg.vocab_size)

    ecfg = EngineConfig(max_batch=4, max_seq_len=128, algorithm="shvs",
                        shvs=SHVSConfig(hot_size=16),   # deliberately tiny
                        k_cap=128, prompt_bucket=8)
    eng = Engine(cfg, params, ecfg, hot_counts=counts, autotune=True,
                 device=dev)
    eng._controller.adjust_every = 8
    eng._controller.hysteresis = 0.15

    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(1, cfg.vocab_size, 8).tolist(),
                    max_new_tokens=args.max_new,
                    sampling=SamplingConfig(temperature=0.9))
            for i in range(args.requests)]
    eng.submit(reqs)
    done = eng.run(max_steps=400)

    print(f"served {len(done)} requests")
    adjustments = [s for s in eng.stats_log if "hot_size" in s]
    print("controller adjustments (step -> new H):")
    for s in adjustments:
        print(f"  step {s['step']:3d}: H -> {s['hot_size']} "
              f"(alpha={s['alpha_mean']:.3f})")
    if eng._controller.history:
        h = eng._controller.history[-1]
        print(f"final: H={h['h_current']} fitted Zipf s={h['s_fit']:.3f} "
              f"alpha(EWMA)={h['alpha']:.3f}")


if __name__ == "__main__":
    main()
