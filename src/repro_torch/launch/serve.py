"""Serving driver of the port: run the engine end to end on one device.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
        --reduced --device cpu --requests 4 --max-new 6

The driver streams tokens through ``Engine.generate()`` (events fire as
tokens commit) and prints a batch report: throughput, TTFT/TPOT
percentiles, and each request's ``finish_reason``. Weights are a seeded
random init in the model's dtype, made on the device. ``--device``
defaults to ``cuda`` and fails without a card.

Flags of the reference driver that this slice does not serve (paged KV,
chunked prefill, pipeline stages, host sampling, gateway, disaggregation,
tracing) raise ``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.config import ARCH_IDS, SamplingConfig, SHVSConfig, get_arch
from repro_torch.core.sampler_backend import registered_backends
from repro_torch.device import resolve_device
from repro_torch.engine.engine import Engine, EngineConfig
from repro_torch.engine.request import Request
from repro_torch.models.model import Model


def build_engine(arch: str, reduced: bool, algorithm: str, batch: int,
                 max_seq: int, seed: int = 0, overlap: bool = True,
                 device="cuda") -> Engine:
    """An engine over a seeded random init of ``arch`` on ``device``."""
    dev = resolve_device(device)
    cfg = get_arch(arch)
    if reduced:
        cfg = cfg.reduced()
    params = Model(cfg).init(seed=seed, device=dev)
    ecfg = EngineConfig(max_batch=batch, max_seq_len=max_seq,
                        algorithm=algorithm,
                        shvs=SHVSConfig(hot_size=min(1024,
                                                     cfg.vocab_size // 4)),
                        k_cap=min(256, cfg.vocab_size), seed=seed,
                        overlap=overlap)
    return Engine(cfg, params, ecfg, device=dev)


def synth_requests(n: int, vocab: int, max_new: int, rng_seed: int = 0,
                   seed=None, greedy: bool = False, stop_sequences=()):
    """The reference driver's synthetic batch (the same prompts for the same
    arguments; its long-prompt mix waits for chunked prefill)."""
    rng = np.random.default_rng(rng_seed)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(4, 24))
        reqs.append(Request(
            request_id=i,
            prompt=rng.integers(1, vocab, plen).tolist(),
            max_new_tokens=max_new,
            sampling=SamplingConfig(temperature=0.8, top_k=40, top_p=0.95,
                                    repetition_penalty=1.1,
                                    seed=None if seed is None else seed + i,
                                    greedy=greedy,
                                    stop_sequences=tuple(stop_sequences)),
        ))
    return reqs


def latency_report(reqs, t0: float, t1: float) -> dict:
    """Throughput and TTFT/TPOT percentiles (ms) of a served batch."""
    toks = sum(len(r.output) for r in reqs)
    tpot = [d for r in reqs if len(r.token_times) > 1
            for d in np.diff(r.token_times)]
    ttft = [r.first_token_time - r.arrival_time for r in reqs
            if r.first_token_time is not None]
    pct = lambda xs, q: float(np.percentile(xs, q) * 1e3) if xs else \
        float("nan")
    return {"requests": len(reqs), "tokens": toks, "seconds": t1 - t0,
            "tok_per_s": toks / (t1 - t0),
            "ttft_p50_ms": pct(ttft, 50), "ttft_p95_ms": pct(ttft, 95),
            "tpot_p50_ms": pct(tpot, 50), "tpot_p95_ms": pct(tpot, 95)}


def serve_batch(eng: Engine, reqs):
    """Stream ``reqs`` through ``eng.generate`` and return the report."""
    t0 = time.perf_counter()
    for r in reqs:
        r.arrival_time = t0
    n_events = sum(1 for _ in eng.generate(reqs))
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    rep = latency_report(reqs, t0, time.perf_counter())
    rep["events"] = n_events
    return rep


_UNPORTED = {
    "cache": ("--cache paged", 6), "prompt_chunk": ("--prompt-chunk", 6),
    "long_prompts": ("--long-prompts (chunked prefill workload)", 6),
    "sampler_mode": ("--sampler-mode", 8), "samplers": ("--samplers", 8),
    "pool_algorithm": ("--pool-algorithm", 8), "gateway": ("--gateway", 9),
    "disaggregate": ("--disaggregate", 9), "trace_out": ("--trace-out", 9),
    "stages": ("--stages", 10), "microbatches": ("--microbatches", 10),
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS), default="smollm-360m")
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced smoke-size config")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for smoke runs)")
    ap.add_argument("--algorithm", default="shvs",
                    choices=registered_backends(),
                    help="sampler backend (decision-plane service registry)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--overlap", dest="overlap", action="store_true",
                    default=True, help="overlapped iteration loop (default)")
    ap.add_argument("--no-overlap", dest="overlap", action="store_false",
                    help="synchronous loop: drain every iteration")
    ap.add_argument("--seed", type=int, default=None,
                    help="per-request sampling seeds (request i gets seed+i)")
    ap.add_argument("--greedy", action="store_true",
                    help="argmax decoding for every request")
    ap.add_argument("--stop", action="append", default=[], metavar="IDS",
                    help="token-level stop sequence as comma-separated ids")
    # the reference driver's flags outside this slice: accepted, refused
    ap.add_argument("--cache", default=None)
    ap.add_argument("--prompt-chunk", type=int, default=None)
    ap.add_argument("--long-prompts", action="store_true", default=None)
    ap.add_argument("--sampler-mode", default=None)
    ap.add_argument("--samplers", type=int, default=None)
    ap.add_argument("--pool-algorithm", default=None)
    ap.add_argument("--gateway", action="store_true", default=None)
    ap.add_argument("--disaggregate", action="store_true", default=None)
    ap.add_argument("--trace-out", default=None)
    ap.add_argument("--stages", type=int, default=None)
    ap.add_argument("--microbatches", type=int, default=None)
    args = ap.parse_args(argv)
    for dest, (flag, item) in _UNPORTED.items():
        val = getattr(args, dest)
        if val is not None and not (dest == "cache" and val == "contiguous"):
            raise NotImplementedError(
                f"{flag} is not ported yet (ROADMAP 'Modules to port' item "
                f"{item})")

    stop_sequences = tuple(
        tuple(int(t) for t in s.split(",") if t.strip()) for s in args.stop)
    eng = build_engine(args.arch, args.reduced, args.algorithm, args.batch,
                       args.max_seq, overlap=args.overlap,
                       device=args.device)
    reqs = synth_requests(args.requests, eng.cfg.vocab_size, args.max_new,
                          seed=args.seed, greedy=args.greedy,
                          stop_sequences=stop_sequences)
    rep = serve_batch(eng, reqs)
    eng.close()
    where = torch.cuda.get_device_name(eng.device) \
        if eng.device.type == "cuda" else "cpu"
    mode = "overlapped" if args.overlap else "sequential"
    print(f"\nserved {rep['requests']} requests, {rep['tokens']} tokens in "
          f"{rep['seconds']:.2f}s ({rep['tok_per_s']:.1f} tok/s) "
          f"[{args.algorithm}, {mode}, {where}]")
    print(f"TTFT p50={rep['ttft_p50_ms']:.1f}ms p95={rep['ttft_p95_ms']:.1f}ms"
          f"  TPOT p50={rep['tpot_p50_ms']:.1f}ms "
          f"p95={rep['tpot_p95_ms']:.1f}ms ({rep['events']} events)")
    print("per-request finish reasons:")
    for r in sorted(reqs, key=lambda r: r.request_id):
        seed_s = "-" if r.sampling.seed is None else str(r.sampling.seed)
        print(f"  req {r.request_id:3d}: {len(r.output):3d} tokens, "
              f"seed={seed_s:>4s}, finish_reason={r.finish_reason}")
    accs = [s.accept_rate for s in eng.stats_log
            if np.isfinite(s.accept_rate)]
    if accs:
        print(f"decision plane: mean fast-path acceptance "
              f"{np.mean(accs):.2%} ({len(eng.stats_log)} iterations)")


if __name__ == "__main__":
    main()
