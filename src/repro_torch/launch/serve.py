"""Serving driver of the port: run the engine end to end on one device.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
        --reduced --device cpu --requests 4 --max-new 6
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \\
        --reduced --device cpu      # also granite-moe-1b-a400m, zamba2-1.2b,
                                    # internvl2-2b (text only)
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \\
        --algorithm gumbel --cache paged --prompt-chunk 8 --long-prompts
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \\
        --sampler-mode host --samplers 2 --trace-out trace.json
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \\
        --stages 2 --microbatches 4 [--sampler-mode baseline]

The driver streams tokens through ``Engine.generate()`` (events fire as
tokens commit) and prints a batch report: throughput, TTFT/TPOT
percentiles, and each request's ``finish_reason``; with the host sampler
pool (``--sampler-mode host`` or ``adaptive``) also the pool's commit
stall, CPU sampling and transfer time per step, and the adaptive
controller's decisions. ``--stages P`` (P > 1) or ``--microbatches M``
serve through the microbatched ``PipelineEngine`` and print its
``pipeline_report()`` (cycles, bubble fraction, stage utilisation, Eq.
4's cycle time, stall, sampler and transfer ms). ``--trace-out`` writes
the flight recorder's Chrome trace. Weights are a seeded random init in
the model's dtype, made on the device, or ``--weights PATH.npz`` in the
layout of ``models.bridge.save_npz`` (the reference's ``Model.init`` tree
goes there with ``save_npz(path, jax.tree_util.tree_map(np.asarray,
params))``). ``--device`` defaults to ``cuda`` and fails without a card.
As in the reference, the VLM (internvl2-2b) is served text only, and
chunked prefill, the paged cache and the pipeline take the dense and MoE
families only; whisper-base is refused (ROADMAP Fault 7).

Prefill/decode disaggregation and the gateway (DESIGN.md §16, §18):

    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
        --disaggregate [--cache paged]
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
        --gateway --replicas 2 [--disaggregate] [--http-port 8100]
    curl -N localhost:8100/v1/completions -d \
        '{"prompt": "the quick brown fox", "max_tokens": 16, "seed": 7}'

``--disaggregate`` alone drives the synthetic batch through a
``HandoffScheduler``: one prefill engine and one decode engine, every
request migrating its KV at its first committed token. ``--gateway``
serves an OpenAI-style completions endpoint (SSE streaming) over
``--replicas`` engines until SIGINT/SIGTERM, then drains; with
``--disaggregate`` the fleet splits into ``--prefill-replicas`` prefill
and ``--decode-replicas`` decode replicas. Every replica computes with
the same parameter tensors (one init, shared read-only).
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
from repro_torch.engine.pipeline import PipelineConfig, PipelineEngine
from repro_torch.engine.request import Request
from repro_torch.models.bridge import load_npz
from repro_torch.models.model import Model
from repro_torch.obs import StepTracer, Telemetry, write_chrome_trace


def build_engine(arch: str, reduced: bool, algorithm: str, batch: int,
                 max_seq: int, seed: int = 0, overlap: bool = True,
                 prompt_chunk: int = 0, cache: str = "contiguous",
                 block_size: int = 16, num_blocks: int = 0,
                 stages: int = 1, microbatches: int = 0, samplers: int = 2,
                 sampler_mode: str = None, pool_algorithm: str = None,
                 telemetry: Telemetry = None, weights: str = None,
                 k_cap: int = 256, device="cuda", params=None,
                 sampling_parallelism: str = "sequence_parallel"):
    """An engine over ``arch`` (an arch id, or a ``ModelConfig``) on
    ``device``: a seeded random init, the
    tree in ``weights`` (an npz of ``models.bridge.save_npz``), or
    ``params`` (a tree on ``device``, shared read-only by replicas). With
    ``stages > 1`` or ``microbatches`` a ``PipelineEngine`` (sampling in
    the host pool unless ``sampler_mode`` says otherwise), else an
    ``Engine`` (sampling on the device unless it says otherwise)."""
    dev = resolve_device(device)
    cfg = get_arch(arch) if isinstance(arch, str) else arch
    if reduced:
        cfg = cfg.reduced()
    if params is None:
        params = load_npz(weights, dev) if weights else \
            Model(cfg).init(seed=seed, device=dev)
    common = dict(max_batch=batch, max_seq_len=max_seq, algorithm=algorithm,
                  shvs=SHVSConfig(hot_size=min(1024, cfg.vocab_size // 4)),
                  k_cap=min(k_cap, cfg.vocab_size), seed=seed, cache=cache,
                  block_size=block_size, num_blocks=num_blocks,
                  samplers=samplers, pool_algorithm=pool_algorithm,
                  sampling_parallelism=sampling_parallelism)
    if stages > 1 or microbatches:
        if prompt_chunk:
            raise ValueError(
                "--prompt-chunk is not supported with --stages/"
                "--microbatches: the pipeline engine prefills prompts "
                "monolithically")
        ecfg = PipelineConfig(stages=stages, microbatches=microbatches,
                              sampler_mode=sampler_mode or "host", **common)
        return PipelineEngine(cfg, params, ecfg, device=dev,
                              telemetry=telemetry)
    ecfg = EngineConfig(overlap=overlap, prompt_chunk=prompt_chunk,
                        sampler_mode=sampler_mode or "device", **common)
    return Engine(cfg, params, ecfg, device=dev, telemetry=telemetry)


def trace_telemetry(trace_out: str) -> Telemetry:
    """A telemetry bundle with the flight recorder on — only built when
    ``--trace-out`` asks for a trace, so default runs pay nothing."""
    return Telemetry(tracer=StepTracer(capacity=65536, enabled=True)) \
        if trace_out else None


def host_pool_report(eng: Engine) -> dict:
    """Means per committed host-mode step of the pool's decomposition:
    the engine's block on the ticket (commit stall), the workers' CPU
    sampling and their wait for the logits (ms; NaN with no host step)."""
    mean = lambda k: float(np.mean([s[k] for s in eng.stats_log if k in s])) \
        if any(k in s for s in eng.stats_log) else float("nan")
    return {"host_steps": sum(1 for s in eng.stats_log if "stall_ms" in s),
            "stall_ms": mean("stall_ms"), "sampler_ms": mean("sampler_ms"),
            "transfer_ms": mean("transfer_ms")}


def synth_requests(n: int, vocab: int, max_new: int, rng_seed: int = 0,
                   long_prompts: bool = False, seed=None, greedy: bool = False,
                   stop_sequences=()):
    """The reference driver's synthetic batch (the same prompts for the same
    arguments); ``long_prompts`` makes every fourth prompt 96-191 tokens
    (chunked prefill's workload)."""
    rng = np.random.default_rng(rng_seed)
    reqs = []
    for i in range(n):
        if long_prompts and i % 4 == 0:
            plen = int(rng.integers(96, 192))
        else:
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


def print_pipeline_report(eng: PipelineEngine) -> None:
    """The pipeline's Eq. 4 report: two lines."""
    rep = eng.pipeline_report()
    util = " ".join(f"s{s}={u:.1%}" for s, u in enumerate(rep["stage_util"]))
    print(f"pipeline: bubble_frac={rep['bubble_frac']:.1%} over "
          f"{rep['cycles']} steady-state cycles, "
          f"cycle={rep['mean_cycle_ms']:.2f}ms, "
          f"commit_stall={rep['stall_ms_mean']:.2f}ms, "
          f"sync_sample={rep['sample_ms_mean']:.2f}ms, "
          f"sampler={rep['sampler_ms_mean']:.2f}ms "
          f"(+{rep['transfer_ms_mean']:.2f}ms transfer)")
    print(f"per-stage utilization: {util}")


def _engine_kwargs(args) -> dict:
    """``build_engine``'s keyword arguments from the command line's
    flags, all but the telemetry."""
    return dict(arch=args.arch, reduced=args.reduced,
                algorithm=args.algorithm, batch=args.batch,
                max_seq=args.max_seq, overlap=args.overlap,
                prompt_chunk=args.prompt_chunk, cache=args.cache,
                block_size=args.block_size, num_blocks=args.num_blocks,
                stages=args.stages, microbatches=args.microbatches,
                samplers=args.samplers, sampler_mode=args.sampler_mode,
                pool_algorithm=args.pool_algorithm, weights=args.weights,
                device=args.device)


def _replicas(args, n: int) -> list:
    """``n`` engines of the command line's flags over ONE parameter tree (made
    by the first, shared read-only by the rest): seeded streams then match
    across replicas."""
    engines = []
    for _ in range(n):
        engines.append(build_engine(
            **_engine_kwargs(args), telemetry=trace_telemetry(args.trace_out),
            params=engines[0].params if engines else None))
    return engines


def _check_single_stage(args) -> None:
    if args.stages > 1 or args.microbatches:
        raise ValueError(
            "--disaggregate needs single-stage engines: the pipeline "
            "engine shards its KV cache per stage and has no migration "
            "seam (DESIGN.md §18)")


def build_fleet(args):
    """``--replicas`` engines over one shared parameter tree, wrapped in a
    :class:`~repro_torch.gateway.fleet.ReplicaFleet`. With
    ``--disaggregate`` the fleet is P prefill-role + D decode-role
    replicas (DESIGN.md §18): ``GatewayServer`` builds its router with
    ``Router.for_fleet``, which installs the decode-placement hook on
    every prefill replica, so each admitted prompt prefills on one
    instance and carries its KV to a decode instance at the first
    committed token."""
    from repro_torch.gateway import ReplicaFleet
    roles = None
    if args.disaggregate:
        _check_single_stage(args)
        n_prefill = args.prefill_replicas or max(1, args.replicas // 2)
        n_decode = args.decode_replicas or max(1, args.replicas - n_prefill)
        roles = ["prefill"] * n_prefill + ["decode"] * n_decode
    n = len(roles) if roles else args.replicas
    return ReplicaFleet(_replicas(args, n), capacity=args.capacity,
                        roles=roles)


def run_gateway(args) -> None:
    """Boot the gateway and serve until SIGINT/SIGTERM, then drain: stop
    admissions, let in-flight streams finish, close every replica."""
    import asyncio
    import signal

    from repro_torch.gateway import GatewayServer

    async def _serve() -> None:
        gw = GatewayServer(build_fleet(args), codec=args.codec,
                           trace=bool(args.trace_out))
        await gw.serve(args.http_host, args.http_port)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        if gw.fleet.disaggregated:
            shape = (f"{len(gw.fleet.prefill_replicas)} prefill + "
                     f"{len(gw.fleet.decode_replicas)} decode replicas")
        else:
            shape = f"{len(gw.fleet.replicas)} replica(s)"
        print(f"gateway listening on http://{gw.host}:{gw.port} "
              f"({shape} on {args.device}, capacity {args.capacity}, "
              f"codec '{args.codec}') — Ctrl-C drains and exits",
              flush=True)
        await stop.wait()
        print("draining gateway ...", flush=True)
        await gw.shutdown()
        for rep in gw.fleet.replicas:
            print(f"  {rep.name}: {rep.stats()}")
        print("gateway closed", flush=True)
        if args.trace_out:
            # after shutdown: every replica drained, every span recorded
            sources = [("gateway", gw.tracer)] + [
                (f"replica:{rep.name}", rep.engine.tracer)
                for rep in gw.fleet.replicas]
            n = write_chrome_trace(args.trace_out, sources)
            print(f"wrote {n} trace events to {args.trace_out} "
                  f"(chrome://tracing / ui.perfetto.dev)")

    asyncio.run(_serve())


def run_disaggregated_batch(args, stop_sequences=()):
    """``--disaggregate`` without ``--gateway``: the synthetic batch
    through a :class:`~repro_torch.engine.handoff.HandoffScheduler` — one
    prefill engine, one decode engine over shared parameters, every
    request migrating its KV at its first committed token (DESIGN.md
    §18). Streams equal a single engine's. Returns (requests, report,
    the two engines' ``migration_stats()``)."""
    from repro_torch.engine import HandoffScheduler
    _check_single_stage(args)
    prefill_eng, decode_eng = _replicas(args, 2)
    hs = HandoffScheduler(prefill_eng, decode_eng)
    reqs = synth_requests(args.requests, prefill_eng.cfg.vocab_size,
                          args.max_new, long_prompts=args.long_prompts,
                          seed=args.seed, greedy=args.greedy,
                          stop_sequences=stop_sequences)
    t0 = time.perf_counter()
    for r in reqs:
        r.arrival_time = t0
    n_events = sum(1 for _ in hs.generate(reqs))
    if prefill_eng.device.type == "cuda":
        torch.cuda.synchronize(prefill_eng.device)
    rep = latency_report(reqs, t0, time.perf_counter())
    rep.update(events=n_events, migrated=hs.migrated)
    stats = [prefill_eng.migration_stats(), decode_eng.migration_stats()]
    hs.close()
    if args.trace_out:
        n = write_chrome_trace(args.trace_out,
                               [("prefill", prefill_eng.tracer),
                                ("decode", decode_eng.tracer)])
        print(f"wrote {n} trace events to {args.trace_out}")
    return reqs, rep, stats


def parse_args(argv=None) -> argparse.Namespace:
    """The serve flags (``argv`` defaults to the command line)."""
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
    ap.add_argument("--prompt-chunk", type=int, default=0,
                    help="chunked-prefill width; 0 = monolithic prefill")
    ap.add_argument("--long-prompts", action="store_true",
                    help="mix in long prompts (exercises chunked prefill)")
    ap.add_argument("--cache", choices=("contiguous", "paged"),
                    default="contiguous",
                    help="KV layout: per-slot slabs or a paged block pool")
    ap.add_argument("--block-size", type=int, default=16,
                    help="tokens per KV block (paged cache)")
    ap.add_argument("--num-blocks", type=int, default=0,
                    help="paged pool size; 0 = memory-equal to contiguous")
    ap.add_argument("--sampler-mode", default=None,
                    choices=("device", "host", "disaggregated", "baseline",
                             "adaptive"),
                    help="decision-plane placement: 'device' samples on the "
                         "card, 'host' in the CPU sampler pool, committed "
                         "one step (pipeline: one re-entry) behind; "
                         "'adaptive' lets the controller switch placement "
                         "and resize the pool online. Default: device for "
                         "the single-stage engine, host for the pipeline. "
                         "'disaggregated'/'baseline' are the pipeline's "
                         "spellings of host/device")
    ap.add_argument("--samplers", type=int, default=2,
                    help="host sampler pool workers")
    ap.add_argument("--pool-algorithm", default=None,
                    choices=registered_backends(),
                    help="pool-level backend override: host-mode workers "
                         "draw with this backend while the engine keeps "
                         "--algorithm")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="enable the flight recorder and write a Chrome "
                         "trace-event JSON (chrome://tracing, "
                         "ui.perfetto.dev) to PATH at exit")
    ap.add_argument("--stages", type=int, default=1,
                    help="pipeline stages; >1 serves through the "
                         "microbatched PipelineEngine")
    ap.add_argument("--microbatches", type=int, default=0,
                    help="microbatches in flight (0 = stages); batch % M = 0")
    ap.add_argument("--weights", default=None, metavar="PATH.npz",
                    help="weights in the layout of models.bridge.save_npz "
                         "instead of the seeded random init")
    ap.add_argument("--gateway", action="store_true",
                    help="serve HTTP/SSE completions over a replica fleet "
                         "instead of a synthetic batch (SIGINT drains)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="gateway engine replicas (shared parameters)")
    ap.add_argument("--disaggregate", action="store_true",
                    help="prefill/decode disaggregation: each request "
                         "prefills on one engine and migrates its KV to a "
                         "decode engine at its first committed token "
                         "(with --gateway: split the fleet into roles)")
    ap.add_argument("--prefill-replicas", type=int, default=0,
                    help="prefill-role replicas under --gateway "
                         "--disaggregate (0 = replicas // 2)")
    ap.add_argument("--decode-replicas", type=int, default=0,
                    help="decode-role replicas under --gateway "
                         "--disaggregate (0 = replicas - prefill)")
    ap.add_argument("--http-host", default="127.0.0.1")
    ap.add_argument("--http-port", type=int, default=8100,
                    help="gateway port (0 = an ephemeral one, printed)")
    ap.add_argument("--capacity", type=int, default=16,
                    help="per-replica open-request bound (429 beyond it)")
    ap.add_argument("--codec", default="byte",
                    help="registered text codec of the gateway")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)

    stop_sequences = tuple(
        tuple(int(t) for t in s.split(",") if t.strip()) for s in args.stop)
    if args.gateway:
        run_gateway(args)
        return
    if args.disaggregate:
        reqs, rep, stats = run_disaggregated_batch(args, stop_sequences)
        print(f"\nserved {rep['requests']} requests, {rep['tokens']} tokens "
              f"in {rep['seconds']:.2f}s ({rep['tok_per_s']:.1f} tok/s) "
              f"[{args.algorithm}, disaggregated prefill/decode, "
              f"{rep['migrated']}/{len(reqs)} requests migrated, "
              f"{args.cache}, {args.device}]")
        print(f"TTFT p50={rep['ttft_p50_ms']:.1f}ms  TPOT p50="
              f"{rep['tpot_p50_ms']:.1f}ms ({rep['events']} events)")
        print(f"migration stats: prefill {stats[0]}, decode {stats[1]}")
        for r in sorted(reqs, key=lambda r: r.request_id):
            print(f"  req {r.request_id:3d}: {len(r.output):3d} tokens, "
                  f"handoffs={r.handoff_count}, "
                  f"finish_reason={r.finish_reason}")
        return
    eng = build_engine(**_engine_kwargs(args),
                       telemetry=trace_telemetry(args.trace_out))
    reqs = synth_requests(args.requests, eng.cfg.vocab_size, args.max_new,
                          long_prompts=args.long_prompts, seed=args.seed,
                          greedy=args.greedy, stop_sequences=stop_sequences)
    rep = serve_batch(eng, reqs)
    eng.close()
    where = torch.cuda.get_device_name(eng.device) \
        if eng.device.type == "cuda" else "cpu"
    pipelined = isinstance(eng, PipelineEngine)
    if pipelined:
        mode = f"pipeline p={eng.p} M={eng.M}, {eng.client.mode} sampling"
    else:
        mode = "overlapped" if args.overlap else "sequential"
        mode += f", {eng.client.mode} sampling"
    host_pool = eng.client.is_host or eng._dpc is not None
    if host_pool:
        mode += f" ({args.sampler_mode or 'host'}, " \
                f"samplers={eng.client.pool.num_workers})"
    if args.prompt_chunk:
        mode += f", prompt_chunk={args.prompt_chunk}"
    if args.cache == "paged":
        mode += (f", paged bs={eng.pcfg.block_size} "
                 f"pool={eng.pcfg.num_blocks} "
                 f"preemptions={eng.scheduler.preemptions}")
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
    if pipelined:
        print_pipeline_report(eng)
    elif host_pool:
        pool = host_pool_report(eng)
        fmt = lambda v: "n/a" if np.isnan(v) else f"{v:.2f}ms"
        print(f"host sampler pool: commit_stall={fmt(pool['stall_ms'])} "
              f"sampler={fmt(pool['sampler_ms'])} "
              f"(+{fmt(pool['transfer_ms'])} transfer) per step over "
              f"{pool['host_steps']} host steps")
    if eng._dpc is not None:
        print(f"adaptive controller: {len(eng._dpc.history)} decisions, "
              f"final placement {eng.client.mode}, "
              f"{eng.client.pool.num_workers} workers")
        for h in eng._dpc.history:
            print(f"  step {h['step']}: {h['action']}")
    accs = [s.accept_rate for s in eng.stats_log
            if np.isfinite(s.accept_rate)]
    if accs:
        print(f"decision plane: mean fast-path acceptance "
              f"{np.mean(accs):.2%} ({len(eng.stats_log)} iterations)")
    if args.trace_out:
        n = write_chrome_trace(args.trace_out, [("engine", eng.tracer)])
        print(f"wrote {n} trace events to {args.trace_out} "
              f"(chrome://tracing / ui.perfetto.dev)")


if __name__ == "__main__":
    main()
