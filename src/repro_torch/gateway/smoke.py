"""Gateway wire-identity smoke: HTTP/SSE stream ≡ in-process stream.

    PYTHONPATH=src python -m repro_torch.gateway.smoke [--replicas 2] \
        [--disaggregate] [--device cpu]

Boots the full gateway stack (fleet → router → HTTP server) on an
ephemeral localhost port, streams seeded completions over real sockets,
and asserts each wire token stream is **bit-identical** to
``Engine.generate()`` on a separately-built engine with the same model
seed. This is the end-to-end statement of the serving contract: seeded
streams are pure functions of (seed, prompt, params) — invariant to
request ids, transport, replica placement, and batch composition — so
the whole gateway stack must be invisible in the tokens. Exits nonzero
on any mismatch. The engines run on ``--device`` (default ``cuda``,
which fails without a card).
"""
from __future__ import annotations

import argparse
import asyncio
import sys

from repro_torch.config import ModelConfig, SamplingConfig, SHVSConfig
from repro_torch.engine import Engine, EngineConfig, Request
from repro_torch.gateway.client import stream_completion
from repro_torch.gateway.codec import ByteCodec
from repro_torch.gateway.fleet import ReplicaFleet
from repro_torch.gateway.http import GatewayServer
from repro_torch.models.model import Model

VOCAB = 512        # > ByteCodec.vocab_limit (257) so text prompts fit

PROMPTS = ("the quick brown fox", "jumps over", "sphinx of black quartz")


def smoke_model() -> ModelConfig:
    return ModelConfig(name="gw-smoke", family="dense", num_layers=2,
                       d_model=32, num_heads=2, num_kv_heads=2, d_ff=64,
                       vocab_size=VOCAB)


def smoke_engine(model_seed: int = 0, cache: str = "contiguous",
                 device="cuda") -> Engine:
    """One smoke-sized engine on ``device``; every call with the same
    ``model_seed`` yields identical parameters (the cross-replica identity
    premise). ``cache="paged"`` exercises the block-pool layout — streams
    are bit-identical either way (DESIGN.md §9), so the disaggregated
    smoke migrates real blocks while the reference stays contiguous."""
    cfg = smoke_model()
    params = Model(cfg).init(seed=model_seed, device=device)
    return Engine(cfg, params, EngineConfig(
        max_batch=4, max_seq_len=96, algorithm="reference",
        shvs=SHVSConfig(hot_size=VOCAB // 4), k_cap=256,
        overlap=True, sampler_mode="device", cache=cache, block_size=16),
        device=device)


def _sampling(seed: int) -> SamplingConfig:
    return SamplingConfig(temperature=0.9, top_k=40, top_p=0.95,
                          repetition_penalty=1.1, seed=seed)


def reference_streams(max_new: int, base_seed: int = 7000,
                      device="cuda") -> dict:
    """In-process ground truth: one ``Engine.generate()`` run per prompt
    on a fresh engine (closed afterwards — also exercises the
    close/rebuild path the fleet relies on)."""
    codec = ByteCodec()
    eng = smoke_engine(device=device)
    try:
        reqs = [Request(request_id=900 + i, prompt=codec.encode(p),
                        max_new_tokens=max_new,
                        sampling=_sampling(base_seed + i))
                for i, p in enumerate(PROMPTS)]
        streams = {r.request_id: [] for r in reqs}
        for ev in eng.generate(reqs):
            if ev.token is not None:
                streams[ev.request_id].append(ev.token)
        return {p: streams[900 + i] for i, p in enumerate(PROMPTS)}
    finally:
        eng.close()


async def wire_streams(replicas: int, max_new: int,
                       base_seed: int = 7000,
                       disaggregate: bool = False, device="cuda") -> dict:
    """The same completions over localhost HTTP/SSE against a live
    gateway; distinct session ids spread requests across replicas.
    ``disaggregate`` splits the fleet into paged prefill/decode roles —
    every request prefills on one replica and decodes on another, and
    the wire streams must STILL be bit-identical (DESIGN.md §18)."""
    if disaggregate:
        assert replicas >= 2, "--disaggregate needs >= 2 replicas"
        n_prefill = replicas // 2
        roles = ["prefill"] * n_prefill + ["decode"] * (replicas - n_prefill)
        engines = [smoke_engine(cache="paged", device=device)
                   for _ in range(replicas)]
        fleet = ReplicaFleet(engines, capacity=4, roles=roles)
    else:
        fleet = ReplicaFleet([smoke_engine(device=device)
                              for _ in range(replicas)], capacity=4)
    gw = GatewayServer(fleet)
    await gw.serve(port=0)
    try:
        results = await asyncio.gather(*[
            stream_completion(gw.host, gw.port, {
                "prompt": p, "max_tokens": max_new,
                "temperature": 0.9, "top_k": 40, "top_p": 0.95,
                "repetition_penalty": 1.1, "seed": base_seed + i,
                "session_id": f"smoke-{i}",
            }) for i, p in enumerate(PROMPTS)])
        if disaggregate:
            moved = sum(r.handed_off for r in fleet.prefill_replicas)
            if moved == 0:
                raise RuntimeError(
                    "disaggregated smoke: no request migrated prefill -> "
                    "decode (handoff path not exercised)")
    finally:
        await gw.shutdown()
    out = {}
    for p, res in zip(PROMPTS, results):
        if res.status != 200:
            raise RuntimeError(f"HTTP {res.status} for {p!r}: {res.error}")
        if res.error is not None:
            raise RuntimeError(f"stream error for {p!r}: {res.error}")
        out[p] = res.tokens
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--disaggregate", action="store_true",
                    help="split the fleet into prefill/decode roles with "
                         "paged-KV migration (DESIGN.md §18)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engines (default cuda)")
    args = ap.parse_args(argv)

    ref = reference_streams(args.max_new, device=args.device)
    wire = asyncio.run(wire_streams(args.replicas, args.max_new,
                                    disaggregate=args.disaggregate,
                                    device=args.device))
    ok = True
    for p in PROMPTS:
        match = wire[p] == ref[p]
        ok &= match
        print(f"[{'ok' if match else 'MISMATCH'}] {p!r}: "
              f"wire={wire[p]} ref={ref[p]}")
    if not ok:
        print("gateway smoke FAILED: wire streams diverged from "
              "in-process Engine.generate()", file=sys.stderr)
        return 1
    mode = (f"{args.replicas} replica(s), disaggregated prefill/decode"
            if args.disaggregate else f"{args.replicas} replica(s)")
    print(f"gateway smoke passed: {len(PROMPTS)} seeded streams over "
          f"HTTP/SSE ({mode}) bit-identical to in-process generation")
    return 0


if __name__ == "__main__":
    sys.exit(main())
