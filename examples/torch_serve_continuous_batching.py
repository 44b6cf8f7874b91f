"""End-to-end serving on the PyTorch port: the continuous batching
engine + SIMPLE decision plane, with a baseline comparison (the paper's
Fig. 3 in miniature; the twin of ``examples/serve_continuous_batching.py``).

A plain client of the decision-plane service API (DESIGN.md §11): requests
stream through ``Engine.generate()`` — ``GenerationEvent`` items fire as
tokens COMMIT (one step behind dispatch under the overlapped loop) and each
request's final event carries its ``finish_reason``.

    PYTHONPATH=src python examples/torch_serve_continuous_batching.py \\
        [--device cpu] [--requests 12] [--max-new 16]
"""
import argparse
import time
from collections import Counter

import numpy as np

from repro_torch.config import SamplingConfig, SHVSConfig, get_arch
from repro_torch.device import resolve_device
from repro_torch.engine import Engine, Request
from repro_torch.engine.engine import EngineConfig
from repro_torch.models.model import Model


def make_requests(cfg, n_requests, max_new, id0=0):
    rng = np.random.default_rng(0)
    return [Request(request_id=id0 + i,
                    prompt=rng.integers(1, cfg.vocab_size, 12).tolist(),
                    max_new_tokens=max_new,
                    sampling=SamplingConfig(temperature=0.9, top_k=50,
                                            top_p=0.95,
                                            repetition_penalty=1.1,
                                            # a stop sequence some streams
                                            # will hit: exercises
                                            # finish_reason="stop"
                                            stop_sequences=((7,),)))
            for i in range(n_requests)]


def run(algorithm: str, params, cfg, device, n_requests=12, max_new=16):
    ecfg = EngineConfig(max_batch=4, max_seq_len=128, algorithm=algorithm,
                        shvs=SHVSConfig(hot_size=128),
                        k_cap=min(128, cfg.vocab_size), prompt_bucket=16)
    eng = Engine(cfg, params, ecfg, device=device)
    # warmup outside the timed region: the first prefill and decode steps
    # (and, on the card, the kernel library's first load)
    for _ in eng.generate(make_requests(cfg, ecfg.max_batch, 2, id0=1000)):
        pass
    reqs = make_requests(cfg, n_requests, max_new)
    t0 = time.perf_counter()
    first_event = None
    n_events = 0
    finish_reasons: Counter = Counter()
    # the streaming surface: events fire at COMMIT time, incrementally
    for ev in eng.generate(reqs):
        n_events += 1
        if first_event is None and ev.token is not None:
            first_event = time.perf_counter() - t0
        if ev.finish_reason is not None:
            finish_reasons[ev.finish_reason] += 1
    dt = time.perf_counter() - t0
    assert sum(finish_reasons.values()) == n_requests, \
        "every request must close its stream with a finish_reason"
    toks = sum(len(r.output) for r in reqs)
    tpot = np.concatenate([np.diff(r.token_times) for r in reqs
                           if len(r.token_times) > 1])
    return {"algorithm": algorithm, "tok_s": toks / dt,
            "p50_ms": float(np.percentile(tpot, 50) * 1e3),
            "p95_ms": float(np.percentile(tpot, 95) * 1e3),
            "first_ev_ms": (first_event or 0.0) * 1e3,
            "finish": dict(finish_reasons)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=16)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_arch("smollm-360m").reduced()
    params = Model(cfg).init(seed=0, device=dev)
    print(f"{'algorithm':18s} {'tok/s':>8s} {'P50 ms':>8s} {'P95 ms':>8s} "
          f"{'1st ev ms':>10s}  finish_reasons")
    for algo in ("reference", "truncation_first", "shvs"):
        r = run(algo, params, cfg, dev, args.requests, args.max_new)
        finish = ",".join(f"{k}={v}" for k, v in sorted(r["finish"].items()))
        print(f"{r['algorithm']:18s} {r['tok_s']:8.1f} {r['p50_ms']:8.2f} "
              f"{r['p95_ms']:8.2f} {r['first_ev_ms']:10.1f}  {finish}")


if __name__ == "__main__":
    main()
