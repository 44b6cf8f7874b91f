"""Quickstart on the PyTorch port: build a model, attach the SIMPLE
decision plane, generate (the twin of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.config import SamplingConfig, SHVSConfig, get_arch
from repro_torch.core import DecisionPlane, build_hot_set
from repro_torch.core.hot_vocab import counts_from_trace, synthetic_trace
from repro_torch.core.sampling import SamplingParams
from repro_torch.device import resolve_device
from repro_torch.models.model import Model


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)

    # 1. a reduced-size model from an assigned architecture config
    cfg = get_arch("tinyllama-1.1b").reduced()
    model = Model(cfg)
    params = model.init(seed=0, device=dev)

    # 2. a hot vocabulary from an offline (here: synthetic Zipf) trace — §5.3
    trace = synthetic_trace(cfg.vocab_size, 50_000, s=1.1)
    hot = build_hot_set(counts_from_trace(trace, cfg.vocab_size), 64,
                        cfg.vocab_size, device=dev)

    # 3. the disaggregated decision plane (SHVS + truncation-first + penalties)
    dp = DecisionPlane(cfg.vocab_size, algorithm="shvs",
                       shvs=SHVSConfig(hot_size=64), hot_set=hot, k_cap=64,
                       device=dev)

    # 4. prefill + decode loop
    B = 4
    prompt = torch.as_tensor(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (B, 8)), dtype=torch.int32, device=dev)
    cache = model.init_cache(B, 128, device=dev)
    logits, cache = model.prefill(
        params, {"tokens": prompt}, cache,
        true_lens=torch.full((B,), 8, dtype=torch.int32, device=dev))
    state = dp.init_state(B, prompt)
    sp = SamplingParams.broadcast(B, SamplingConfig(
        temperature=0.8, top_k=40, repetition_penalty=1.1), device=dev)

    out = []
    tokens, state, stats = dp.step(logits, state, sp, 0)
    out.append(tokens)
    for step in range(1, 16):
        logits, cache = model.decode_step(params, tokens, cache)
        tokens, state, stats = dp.step(logits, state, sp, step)
        out.append(tokens)
    seqs = torch.stack(out, dim=1).cpu()
    print("generated token ids:")
    for b in range(B):
        print(f"  seq {b}: {seqs[b].tolist()}")
    print(f"decision plane: fast-path acceptance={float(stats.accept_rate):.2f} "
          f"hot mass alpha={float(stats.alpha_mean):.2f}")


if __name__ == "__main__":
    main()
