#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the exit code is then non-zero):

1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc
   per source, in parallel), printing the nvcc commands and ptxas lines;
2. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes (B = 8, V = 49152, H = 1024, k_cap = 256) and at
   edge shapes (B = 1 and 3, a V no block size divides, τ = 0 rows,
   ±1e4 logits, all-hot and no-hot sets; for ``gumbel_argmax`` -1e30
   entries, a NaN row and seed 324, whose hash gives u == 1.0 at row 0,
   column 32466 of a V = 49152 operand), and time kernel and plain
   version with CUDA events, in turns, after a warm-up;
3. hold the port's CUDA forward against its CPU forward on a small f32
   model (the CPU forward is what the tests hold against the reference);
4. serve 8 seeded requests of 16 new tokens at the full width of
   smollm-360m (bf16, seeded random weights, batch 8, max_seq 256) with the
   ``shvs`` and the ``fused`` backends, with every launch counter set to 0
   just before the run and read just after; check that steady-state steps
   of the overlapped loop make no synchronising call; then check that
   greedy streams are equal across ``reference``, ``shvs`` and ``fused``;
   then the second path: 8 requests of 32 new tokens, every fourth prompt
   96-191 tokens, half of them pure temperature, through the ``gumbel``
   backend on the paged cache (blocks of 16, a pool of 16 blocks, so
   decode growth preempts) with chunked prefill (64): every request
   finishes with its length, ``gumbel_argmax`` launches, two runs give
   equal streams, greedy paged ≡ contiguous (monolithic prefill), greedy
   ``gumbel`` ≡ ``reference``, the paged steady state makes no
   synchronising call; chunked-and-preempted greedy streams are compared
   with monolithic ones and the agreement reported (bf16 GEMMs of other
   shapes may round differently, so equality is not asserted);
5. profile steady-state decode steps of those engines (host wall time,
   device busy time and idle share, launches per step).

The last two lines of standard output are the ``kernels`` JSON object and
``{"ok": true, "device": {...}}``. A longer report goes to
``chiprun_out/chip_smoke_report.json``. Imports torch and the port only.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, published
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores

B_MAIN, V_MAIN, H_MAIN, K_CAP = 8, 49152, 1024, 256
V_ODD = 50021                  # divisible by no power-of-two block
PAGED = dict(cache="paged", block_size=16, num_blocks=16, prompt_chunk=64)
PAGED_NEW = 32                 # new tokens a request on the paged path
U_ONE_SEED, U_ONE_COL = 324, 32466   # hash(324, 0, 32466) rounds to u = 1
BLOCK_V = 2048                 # the fused backend's tiling
SLEEP_CYCLES = 400_000_000     # about 0.2 s of device sleep at 1.98 GHz
SLEEP_MS = 150.0               # the least that sleep lasts on the card


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, n: int, ahead: bool) -> float:
    """ms per call over ``n`` back-to-back calls, from CUDA events.

    ``ahead``: the stream first sleeps while the host enqueues all ``n``
    calls, so the events time the device work alone; otherwise the host's
    launch overhead is included (the rate a caller issuing one call at a
    time sees)."""
    import torch
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if ahead:
        torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    enqueue_s = time.perf_counter() - t0
    end.synchronize()
    ms = start.elapsed_time(end) / n
    # an enqueue that outlasts the sleep waited on the stream somewhere:
    # host time then leaks into the measurement
    blocked = ahead and enqueue_s * 1e3 >= SLEEP_MS
    return ms, blocked


def time_in_turns(name, kernel, plain, n_kernel=50, n_plain=5, rounds=5):
    """Median ms per call of kernel and plain version, timed alternately
    (kernel, plain, plain, kernel, ...) after a warm-up of each. Returns
    (kernel device ms, plain ms, kernel ms with launch overhead, whether
    the plain version blocked the host on the stream)."""
    import statistics
    for _ in range(3):
        kernel()
        plain()
    ks, ps, kl, plain_blocked = [], [], [], False
    for r in range(rounds):
        order = (0, 1) if r % 2 == 0 else (1, 0)
        for which in order:
            if which == 0:
                ms, blocked = time_ms(kernel, n_kernel, ahead=True)
                assert not blocked, f"{name} kernel synchronised the host"
                ks.append(ms)
            else:
                ms, blocked = time_ms(plain, n_plain, ahead=True)
                plain_blocked |= blocked
                ps.append(ms)
        kl.append(time_ms(kernel, n_kernel, ahead=False)[0])
    return statistics.median(ks), statistics.median(ps), \
        statistics.median(kl), plain_blocked


def make_inputs(B, V, gen, dev, *, scale=1.5, tau_zero=(), extremes=False):
    """Seeded decision-plane inputs: logits ~ N(0, scale^2) (a regime where
    the top-K mass stays clear of 1 in f32, see ROADMAP 'Faults'), sparse
    histograms, heterogeneous per-row controls."""
    import torch
    f = dict(device=dev)
    z = torch.randn((B, V), generator=gen, **f) * scale
    if extremes:
        z[0, 17] = 1e4
        z[-1, :64] = -1e4
    sparse = lambda: (torch.randint(0, 3, (B, V), generator=gen, **f) *
                      (torch.rand((B, V), generator=gen, **f) < 0.05)
                      ).to(torch.int32)
    cp, co = sparse(), sparse()
    u = lambda lo, hi: lo + (hi - lo) * torch.rand((B,), generator=gen, **f)
    temp = u(0.5, 1.5)
    for r in tau_zero:
        temp[r] = 0.0
    pick = lambda vals: torch.tensor(vals, **f)[
        torch.randint(0, len(vals), (B,), generator=gen, **f)]
    return dict(z=z, cp=cp, co=co, rep=u(1.0, 1.5), pres=u(0.0, 0.5),
                freq=u(0.0, 0.3), temp=temp,
                top_k=pick([0, 0, 1, 40, 300]).to(torch.int32),
                top_p=pick([1.0, 1.0, 0.95, 0.5]).float(),
                min_p=pick([0.0, 0.0, 0.05]).float(), u=u(0.0, 1.0))


def hot_mask(V, kind, dev):
    import torch
    m = torch.zeros((V,), dtype=torch.bool, device=dev)
    if kind == "all":
        m[:] = True
    elif kind == "first":
        m[:min(H_MAIN, V)] = True
    return m


def check_kernels(dev):
    """Phase 2: every kernel against its plain version; returns per-kernel
    errors and timings at the main path's shapes."""
    import torch
    from repro_torch.kernels import (fused_kernel, gumbel_kernel,
                                     penalty_kernel, ref, shvs_kernel)
    gen = torch.Generator(device=dev).manual_seed(1234)
    cases = [(B_MAIN, V_MAIN, "first", (), False),
             (1, V_MAIN, "first", (), False),
             (3, V_ODD, "first", (1,), True),
             (B_MAIN, V_ODD, "all", (0, 5), False),
             (B_MAIN, V_MAIN, "none", (2,), True)]
    err = {"penalty_scale": 0.0, "shvs_masses": 0.0, "fused_sample": 0.0,
           "gumbel_argmax": 0.0}
    for B, V, hk, tz, ext in cases:
        x = make_inputs(B, V, gen, dev, tau_zero=tz, extremes=ext)
        hot = hot_mask(V, hk, dev)
        pen_args = (x["z"], x["cp"], x["co"], x["rep"], x["pres"],
                    x["freq"], x["temp"])
        got = penalty_kernel.penalty_scale(*pen_args)
        want = ref.penalty_ref(*pen_args)
        torch.cuda.synchronize()
        assert torch.equal(got, want), \
            f"penalty_scale differs from penalty_ref at B={B} V={V}"
        zs = want
        got = shvs_kernel.shvs_masses(zs, hot)
        want = ref.shvs_mass_ref(zs, hot)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[3], want[3]), \
            f"shvs_masses m/tail_max differ at B={B} V={V} hot={hk}"
        for g, w in zip(got[1:3], want[1:3]):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=0)
        err["shvs_masses"] = max(err["shvs_masses"], max(
            (g - w).abs().max().item() for g, w in zip(got, want)))
        f_args = pen_args + (x["top_k"], x["top_p"], x["min_p"], x["u"], hot)
        got = fused_kernel.fused_sample(*f_args, k_cap=K_CAP, block_v=BLOCK_V)
        want = ref.fused_sample_ref(*f_args, k_cap=K_CAP, block_v=BLOCK_V)
        torch.cuda.synchronize()
        for name, i in (("tokens", 0), ("exact", 1), ("kept", 3)):
            assert torch.equal(got[i], want[i]), (
                f"fused_sample {name} differ at B={B} V={V} hot={hk}: "
                f"{got[i].tolist()} vs {want[i].tolist()}")
        torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=0)
        err["fused_sample"] = max(err["fused_sample"],
                                  (got[2] - want[2]).abs().max().item())
        print(f"kernel check B={B} V={V} hot={hk} tau0={list(tz)} "
              f"extremes={ext}: ok")

    # gumbel_argmax: tokens equal (max_abs_err is the largest token gap)
    for B, V in ((B_MAIN, V_MAIN), (1, V_MAIN), (3, V_ODD)):
        z = torch.randn((B, V), generator=gen, device=dev) * 2.0
        z[-1, :V // 3] = -1e30
        if B > 2:
            z[1, [7, 4099]] = float("nan")
        for seed in (0, 42, U_ONE_SEED, 3000009007):
            got = gumbel_kernel.gumbel_argmax(z, seed)
            want = ref.gumbel_argmax_ref(z, seed)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (
                f"gumbel_argmax differs at B={B} V={V} seed={seed}: "
                f"{got.tolist()} vs {want.tolist()}")
            if B > 2:
                assert int(got[1]) == 7, "the first NaN must win"
            if seed == U_ONE_SEED and V == V_MAIN:
                assert int(got[0]) == U_ONE_COL, (
                    "u == 1.0 must win row 0 as in the reference", got[0])
        print(f"kernel check gumbel_argmax B={B} V={V} (-1e30 entries"
              f"{', NaN row' if B > 2 else ''}, seeds 0/42/324/3000009007, "
              f"u == 1.0 at column {U_ONE_COL}): ok")

    # timings at the main path's shapes (B=8, V=49152, H=1024, k_cap=256)
    x = make_inputs(B_MAIN, V_MAIN, gen, dev)
    hot = hot_mask(V_MAIN, "first", dev)
    pen_args = (x["z"], x["cp"], x["co"], x["rep"], x["pres"], x["freq"],
                torch.ones_like(x["temp"]))      # the shell's τ = 1 pass
    zs = ref.penalty_ref(x["z"], x["cp"], x["co"], x["rep"], x["pres"],
                         x["freq"], x["temp"])
    f_args = pen_args[:6] + (x["temp"], x["top_k"], x["top_p"], x["min_p"],
                             x["u"], hot)
    B, V = B_MAIN, V_MAIN
    timing = {}
    timing["penalty_scale"] = time_in_turns(
        "penalty_scale", lambda: penalty_kernel.penalty_scale(*pen_args),
        lambda: ref.penalty_ref(*pen_args))
    timing["shvs_masses"] = time_in_turns(
        "shvs_masses", lambda: shvs_kernel.shvs_masses(zs, hot),
        lambda: ref.shvs_mass_ref(zs, hot))
    # the plain version issues ~400 launches a call: one call per
    # measurement keeps the queue below the device's depth limit
    timing["fused_sample"] = time_in_turns(
        "fused_sample",
        lambda: fused_kernel.fused_sample(*f_args, k_cap=K_CAP,
                                          block_v=BLOCK_V),
        lambda: ref.fused_sample_ref(*f_args, k_cap=K_CAP, block_v=BLOCK_V),
        n_kernel=50, n_plain=1)
    timing["gumbel_argmax"] = time_in_turns(
        "gumbel_argmax", lambda: gumbel_kernel.gumbel_argmax(zs, 1234),
        lambda: ref.gumbel_argmax_ref(zs, 1234))
    # least time for the same work: each input read once, each output
    # written once, over the memory rate; element operations over the f32
    # rate (rough counts: the byte bound is larger by two orders)
    moved = {"penalty_scale": B * V * (4 + 4 + 4) + B * V * 4 + 4 * B * 4,
             "shvs_masses": B * V * 4 + V * 1 + 4 * B * 4,
             "fused_sample": B * V * 12 + V * 1 + 8 * B * 4 + B * 13,
             "gumbel_argmax": B * V * 4 + B * 4}
    # gumbel_argmax: two logf an element (counted at the f32 rate)
    ops = {"penalty_scale": 10 * B * V, "shvs_masses": 8 * B * V,
           "fused_sample": 30 * B * V, "gumbel_argmax": 2 * B * V}
    bounds = {}
    for k in moved:
        t_bytes = moved[k] / HBM_BYTES_PER_S * 1e3
        t_ops = ops[k] / F32_FLOPS * 1e3
        bounds[k] = (max(t_bytes, t_ops),
                     "bytes" if t_bytes >= t_ops else "operations", moved[k])
    return err, timing, bounds


def check_model(dev):
    """Phase 3: the CUDA forward against the CPU forward on a reduced f32
    model (prefill + 3 decode steps)."""
    import torch
    from repro_torch.config import get_arch
    from repro_torch.models.model import Model
    cfg = get_arch("smollm-360m").reduced()
    model = Model(cfg)
    params_cpu = model.init(seed=5, device="cpu")
    to = lambda t, d: {k: to(v, d) if isinstance(v, dict) else v.to(d)
                       for k, v in t.items()}
    params_gpu = to(params_cpu, dev)
    gen = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (3, 20), generator=gen,
                         dtype=torch.int32)
    lens = torch.tensor([20, 11, 7], dtype=torch.int32)
    steps = torch.randint(0, cfg.vocab_size, (3, 3), generator=gen,
                          dtype=torch.int32)
    worst = 0.0
    outs = []
    for d, p in (("cpu", params_cpu), (dev, params_gpu)):
        cache = model.init_cache(3, 32, device=d)
        logits, cache = model.prefill(p, {"tokens": toks.to(d)}, cache,
                                      true_lens=lens.to(d))
        seq = [logits.cpu()]
        for nxt in steps:
            logits, cache = model.decode_step(p, nxt.to(d), cache)
            seq.append(logits.cpu())
        outs.append(seq)
    for a, b in zip(*outs):
        assert torch.isfinite(b).all()
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-4)
        worst = max(worst, (a - b).abs().max().item())
    print(f"model check (reduced f32, CUDA vs CPU forward): max abs err "
          f"{worst:.3g}")
    return worst


def engine(algorithm, dev, **kw):
    """The serve driver's engine (``launch/serve.py build_engine``) for
    full-width smollm-360m: bf16 weights from seed 0, batch 8, max_seq 256,
    H = 1024, k_cap = 256; ``kw`` (cache, block_size, num_blocks,
    prompt_chunk) go to ``build_engine``."""
    from repro_torch.launch.serve import build_engine
    eng = build_engine("smollm-360m", False, algorithm, B_MAIN, 256,
                       device=dev, **kw)
    cfg = eng.cfg
    assert cfg.num_layers == 32 and cfg.d_model == 960 and \
        cfg.vocab_size == V_MAIN and cfg.dtype == "bfloat16"
    assert eng.ecfg.shvs.resolve_hot_size(V_MAIN) == H_MAIN and \
        eng.decision.k_cap == K_CAP
    return eng


def serve(dev, card):
    """Phase 4: the full-width engine through the serve driver's entry
    points; returns launch counts, reports and the greedy streams."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_batch, synth_requests
    V = V_MAIN
    runs, counts = {}, {}
    for algorithm in ("shvs", "fused"):
        eng = engine(algorithm, dev)
        if algorithm == "shvs":
            n_params = sum(t.numel() for t in _leaves(eng.params))
            print(f"smollm-360m full width: {n_params} parameters (bf16, "
                  f"seeded init)")
        serve_batch(eng, synth_requests(2, V, 2, rng_seed=99, seed=0))  # warm
        reqs = synth_requests(8, V, 16, seed=0)
        ops.reset_launch_counts()
        rep = serve_batch(eng, reqs)
        counts[algorithm] = ops.launch_counts()
        eng.close()
        for r in reqs:
            assert r.finish_reason == "length" and len(r.output) == 16, \
                (algorithm, r.request_id, r.finish_reason, len(r.output))
            assert all(0 <= t < V for t in r.output)
        rep["launches"] = counts[algorithm]
        runs[algorithm] = rep
        print(f"serve {algorithm}: {rep['requests']} requests, "
              f"{rep['tokens']} tokens, {rep['tok_per_s']:.1f} tok/s, "
              f"TTFT p50 {rep['ttft_p50_ms']:.2f} ms, TPOT p50 "
              f"{rep['tpot_p50_ms']:.2f} ms, launches {counts[algorithm]} "
              f"[{card}]")
    assert counts["shvs"]["penalty_scale"] > 0, counts
    assert counts["shvs"]["shvs_masses"] > 0, counts
    assert counts["fused"]["fused_sample"] > 0, counts

    # the overlapped loop must never block the host on the stream: in
    # steady state (no admissions) a step enqueues the decode and waits
    # only on the previous step's event; any synchronising call raises
    eng = engine("shvs", dev)
    eng.submit(synth_requests(8, V, 8, seed=0))
    eng.step()                  # admission reads the first tokens back
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            eng.step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    eng.flush()
    eng.close()
    print("overlap check: 3 steady-state steps made no synchronising call")

    streams = {}
    for algorithm in ("reference", "shvs", "fused"):
        eng = engine(algorithm, dev)
        reqs = synth_requests(8, V, 16, greedy=True)
        rep = serve_batch(eng, reqs)
        eng.close()
        streams[algorithm] = [r.output for r in reqs]
        runs[f"greedy_{algorithm}"] = rep
        print(f"serve greedy {algorithm}: {rep['tok_per_s']:.1f} tok/s, "
              f"TPOT p50 {rep['tpot_p50_ms']:.2f} ms [{card}]")
    assert streams["reference"] == streams["shvs"] == streams["fused"], \
        "greedy streams differ across backends"
    print("greedy streams equal across reference, shvs, fused: "
          f"{sum(len(s) for s in streams['fused'])} tokens")
    return runs, counts


def paged_requests(V, greedy=False, max_new=PAGED_NEW):
    """The second path's batch: the serve driver's long-prompt mix, half of
    it pure temperature (top_k = 0, top_p = 1), so the gumbel kernel's
    draws are the tokens committed for those rows."""
    import dataclasses
    from repro_torch.launch.serve import synth_requests
    reqs = synth_requests(8, V, max_new, long_prompts=True, seed=0,
                          greedy=greedy)
    for r in reqs[::2]:
        r.sampling = dataclasses.replace(r.sampling, top_k=0, top_p=1.0)
    return reqs


def top2_gap(eng, ctx, dev):
    """Gap between the two largest logits after ``ctx`` (monolithic
    contiguous prefill, the raw logits before penalties)."""
    import torch
    cache = eng.model.init_cache(1, 256, device=dev)
    toks = torch.tensor([ctx], dtype=torch.int32, device=dev)
    logits, _ = eng.model.prefill(eng.params, {"tokens": toks}, cache,
                                  true_lens=torch.tensor(
                                      [len(ctx)], dtype=torch.int32,
                                      device=dev))
    top = logits[0].topk(2).values
    return float(top[0] - top[1])


def agreement(eng, a, b, dev):
    """Token agreement of two greedy runs of the same requests: tokens equal
    up to each request's first difference over all tokens, and at the
    first difference the top-two logit gap of the contiguous forward."""
    same, total, first = 0, 0, None
    for ra, rb in zip(a, b):
        n = min(len(ra.output), len(rb.output))
        j = next((i for i in range(n) if ra.output[i] != rb.output[i]), n)
        same += j
        total += max(len(ra.output), len(rb.output))
        if j < n and first is None:
            first = {"request": ra.request_id, "position": j,
                     "top2_gap": top2_gap(
                         eng, list(ra.prompt) + ra.output[:j], dev)}
    return {"agreement": same / total, "first_difference": first}


def serve_paged(dev, card):
    """Phase 4, second path: gumbel + paged KV + chunked prefill under pool
    pressure, through the serve driver's entry points."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_batch, synth_requests
    V = V_MAIN
    out, streams = {}, []
    for run in range(2):
        eng = engine("gumbel", dev, **PAGED)
        serve_batch(eng, synth_requests(2, V, 2, rng_seed=99, seed=0))
        p0 = eng.scheduler.preemptions
        reqs = paged_requests(V)
        ops.reset_launch_counts()
        rep = serve_batch(eng, reqs)
        counts = ops.launch_counts()
        rep["preemptions"] = eng.scheduler.preemptions - p0
        eng.close()
        for r in reqs:
            assert r.finish_reason == "length" and \
                len(r.output) == PAGED_NEW, \
                (r.request_id, r.finish_reason, len(r.output))
            assert all(0 <= t < V for t in r.output)
        assert rep["preemptions"] > 0, "the pool was meant to exhaust"
        assert counts["gumbel_argmax"] > 0 and counts["penalty_scale"] > 0, \
            counts
        assert eng.alloc.num_free == eng.pcfg.num_blocks
        streams.append([r.output for r in reqs])
        rep["launches"] = counts
        out[f"gumbel_paged_run{run}"] = rep
        print(f"serve gumbel paged (blocks {PAGED['block_size']}, pool "
              f"{PAGED['num_blocks']}, prompt_chunk {PAGED['prompt_chunk']}, "
              f"long prompts): {rep['requests']} requests, {rep['tokens']} "
              f"tokens, {rep['tok_per_s']:.1f} tok/s, TTFT p50 "
              f"{rep['ttft_p50_ms']:.2f} ms, TPOT p50 "
              f"{rep['tpot_p50_ms']:.2f} ms, {rep['preemptions']} "
              f"preemptions, launches {counts} [{card}]")
    assert streams[0] == streams[1], "two runs gave different streams"
    print("gumbel paged: two runs gave equal streams")

    # the paged steady state must not block the host either: block-table
    # uploads are non_blocking copies and nothing is read back
    eng = engine("gumbel", dev, cache="paged", block_size=16,
                 prompt_chunk=64)
    eng.submit(paged_requests(V)[1::2])       # short prompts: no chunks
    eng.step()                  # admission reads the first tokens back
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(4):
            eng.step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    eng.flush()
    eng.close()
    print("paged overlap check: 4 steady-state steps made no synchronising "
          "call")

    greedy = {}
    for name, algorithm, kw in (
            ("contiguous", "reference", {}),
            ("paged", "reference", dict(cache="paged", block_size=16)),
            ("paged_chunked_preempted", "reference", PAGED),
            ("gumbel_paged_chunked_preempted", "gumbel", PAGED)):
        eng = engine(algorithm, dev, **kw)
        reqs = paged_requests(V, greedy=True)
        rep = serve_batch(eng, reqs)
        rep["preemptions"] = eng.scheduler.preemptions
        eng.close()
        greedy[name] = reqs
        out[f"greedy_{name}"] = rep
    tok = lambda n: [r.output for r in greedy[n]]
    assert tok("paged") == tok("contiguous"), \
        "greedy paged streams differ from contiguous ones"
    assert tok("gumbel_paged_chunked_preempted") == \
        tok("paged_chunked_preempted"), "greedy gumbel differs from reference"
    cmp = agreement(eng, greedy["paged_chunked_preempted"],
                    greedy["contiguous"], dev)
    out["greedy_chunked_preempted_vs_monolithic"] = cmp
    print(f"greedy paged ≡ contiguous (monolithic prefill): "
          f"{sum(len(s) for s in tok('paged'))} tokens; greedy gumbel ≡ "
          f"reference on the chunked, preempting path "
          f"({out['greedy_paged_chunked_preempted']['preemptions']} "
          f"preemptions)")
    print(f"greedy chunked+preempted vs monolithic contiguous: token "
          f"agreement {cmp['agreement']:.4f}, first difference "
          f"{cmp['first_difference']} [{card}]")
    return out, counts


def profile_steps(dev, card):
    """Phase 5: where a steady-state decode step's time goes on each path
    (full width, batch 8): host wall time per step, device busy time per
    step (sum of kernel times from torch.profiler), the idle share, kernel
    launches per step, and the decision-plane kernels' share. The paged
    row uses the second path's batch and chunk width with a pool that
    holds every slot (no preemption inside the window); its long prompts
    are prefilled before the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import synth_requests
    out = {}
    paths = (("shvs", "shvs", {}), ("fused", "fused", {}),
             ("gumbel_paged", "gumbel",
              dict(cache="paged", block_size=16, prompt_chunk=64)))
    for name, algorithm, kw in paths:
        eng = engine(algorithm, dev, **kw)
        if kw:
            eng.submit(paged_requests(V_MAIN, max_new=64))
        else:
            eng.submit(synth_requests(8, V_MAIN, 64, seed=0))
        for _ in range(6):
            eng.step()
        torch.cuda.synchronize()
        n = 10
        t0 = time.perf_counter()
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / n * 1e3
        n_prof = 5
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n_prof):
                eng.step()
            torch.cuda.synchronize()
        eng.flush()
        eng.close()
        busy_us, launches, ours = 0.0, 0, {}
        for evt in prof.key_averages():
            dev_us = getattr(evt, "self_device_time_total", None)
            if dev_us is None:
                dev_us = evt.self_cuda_time_total
            if evt.key in ("cudaLaunchKernel", "cuLaunchKernelEx",
                           "cudaLaunchKernelExC", "cuLaunchKernel"):
                launches += evt.count
            elif dev_us > 0 and not evt.key.startswith("aten::"):
                busy_us += dev_us
                for k in ("penalty_scale", "shvs_masses", "fused_sample",
                          "gumbel_argmax"):
                    if evt.key.startswith(k + "_"):
                        ours[k] = ours.get(k, 0.0) + dev_us / n_prof / 1e3
        busy_ms = busy_us / n_prof / 1e3
        out[name] = {"wall_ms_per_step": wall_ms,
                          "device_busy_ms_per_step": busy_ms,
                          "idle_share": 1.0 - busy_ms / wall_ms,
                          "launches_per_step": launches / n_prof,
                          "decision_kernels_ms_per_step": ours}
        print(f"step profile {name}: wall {wall_ms:.2f} ms/step, device "
              f"busy {busy_ms:.2f} ms/step (idle share "
              f"{1.0 - busy_ms / wall_ms:.1%}), {launches / n_prof:.0f} "
              f"launches/step, decision kernels {ours} [{card}]")
    return out


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build, fused_kernel, gumbel_kernel, \
        ops, penalty_kernel, shvs_kernel
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}; allow_tf32=False, "
          f"allow_bf16_reduced_precision_reduction=False")

    t0 = time.perf_counter()
    lib = _build.build()
    print(f"kernels built in {time.perf_counter() - t0:.1f}s: {lib.name}")
    for line in _build.BUILD_LOG:
        print(f"  {line}")

    err, timing, bounds = check_kernels(dev)
    model_err = check_model(dev)
    runs, counts = serve(dev, card)
    paged_runs, counts["gumbel_paged"] = serve_paged(dev, card)
    runs.update(paged_runs)
    steps = profile_steps(dev, card)

    launch_of = {"penalty_scale": counts["shvs"]["penalty_scale"],
                 "shvs_masses": counts["shvs"]["shvs_masses"],
                 "fused_sample": counts["fused"]["fused_sample"],
                 "gumbel_argmax": counts["gumbel_paged"]["gumbel_argmax"]}
    kernels = []
    for mod in (penalty_kernel, shvs_kernel, fused_kernel, gumbel_kernel):
        k_ms, p_ms, launch_ms, p_blocked = timing[mod.NAME]
        b_ms, b_by, nbytes = bounds[mod.NAME]
        kernels.append({
            "name": mod.NAME, "route": "cuda", "source": mod.SOURCE,
            "replaces": mod.REPLACES, "launches": launch_of[mod.NAME],
            "max_abs_err": err[mod.NAME], "ms": k_ms, "kernel_ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "launch_ms": launch_ms,
            "plain_blocked_host": p_blocked})
        print(f"{mod.NAME}: kernel {k_ms:.4f} ms on the device "
              f"({launch_ms:.4f} ms a call with launch overhead), "
              f"plain {p_ms:.4f} ms"
              f"{' (plain call waited on the stream)' if p_blocked else ''}, "
              f"bound {b_ms:.5f} ms ({nbytes} bytes), "
              f"launches {launch_of[mod.NAME]} [{card}]")
    report = {"card": card, "torch": torch.__version__, "kernels": kernels,
              "model_check_max_abs_err": model_err, "runs": runs,
              "step_profile": steps}
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke_report.json").write_text(json.dumps(report, indent=1))
    assert set(ops.launch_counts()) == {k["name"] for k in kernels}
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
