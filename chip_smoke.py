#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the exit code is then non-zero):

1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc
   per source, in parallel), printing the nvcc commands and ptxas lines;
2. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes (B = 8, V = 49152, H = 1024, k_cap = 256) and at
   edge shapes (B = 1 and 3, a V no block size divides, τ = 0 rows,
   ±1e4 logits, all-hot and no-hot sets), and time kernel and plain
   version with CUDA events, in turns, after a warm-up;
3. hold the port's CUDA forward against its CPU forward on a small f32
   model (the CPU forward is what the tests hold against the reference);
4. serve 8 seeded requests of 16 new tokens at the full width of
   smollm-360m (bf16, seeded random weights, batch 8, max_seq 256) with the
   ``shvs`` and the ``fused`` backends, with every launch counter set to 0
   just before the run and read just after; check that steady-state steps
   of the overlapped loop make no synchronising call; then check that
   greedy streams are equal across ``reference``, ``shvs`` and ``fused``;
5. profile steady-state decode steps of that engine (host wall time,
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
    from repro_torch.kernels import (fused_kernel, penalty_kernel, ref,
                                     shvs_kernel)
    gen = torch.Generator(device=dev).manual_seed(1234)
    cases = [(B_MAIN, V_MAIN, "first", (), False),
             (1, V_MAIN, "first", (), False),
             (3, V_ODD, "first", (1,), True),
             (B_MAIN, V_ODD, "all", (0, 5), False),
             (B_MAIN, V_MAIN, "none", (2,), True)]
    err = {"penalty_scale": 0.0, "shvs_masses": 0.0, "fused_sample": 0.0}
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
    # least time for the same work: each input read once, each output
    # written once, over the memory rate; element operations over the f32
    # rate (rough counts: the byte bound is larger by two orders)
    moved = {"penalty_scale": B * V * (4 + 4 + 4) + B * V * 4 + 4 * B * 4,
             "shvs_masses": B * V * 4 + V * 1 + 4 * B * 4,
             "fused_sample": B * V * 12 + V * 1 + 8 * B * 4 + B * 13}
    ops = {"penalty_scale": 10 * B * V, "shvs_masses": 8 * B * V,
           "fused_sample": 30 * B * V}
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


def engine(algorithm, dev):
    """The serve driver's engine (``launch/serve.py build_engine``) for
    full-width smollm-360m: bf16 weights from seed 0, batch 8, max_seq 256,
    H = 1024, k_cap = 256."""
    from repro_torch.launch.serve import build_engine
    eng = build_engine("smollm-360m", False, algorithm, B_MAIN, 256,
                       device=dev)
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


def profile_steps(dev, card):
    """Phase 5: where a steady-state decode step's time goes on the main
    path (shvs, full width, batch 8): host wall time per step, device busy
    time per step (sum of kernel times from torch.profiler), the idle
    share, kernel launches per step, and the decision-plane kernels'
    share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import synth_requests
    out = {}
    for algorithm in ("shvs", "fused"):
        eng = engine(algorithm, dev)
        eng.submit(synth_requests(8, V_MAIN, 64, seed=0))
        for _ in range(4):
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
                for k in ("penalty_scale", "shvs_masses", "fused_sample"):
                    if evt.key.startswith(k + "_kernel"):
                        ours[k] = dev_us / n_prof / 1e3
        busy_ms = busy_us / n_prof / 1e3
        out[algorithm] = {"wall_ms_per_step": wall_ms,
                          "device_busy_ms_per_step": busy_ms,
                          "idle_share": 1.0 - busy_ms / wall_ms,
                          "launches_per_step": launches / n_prof,
                          "decision_kernels_ms_per_step": ours}
        print(f"step profile {algorithm}: wall {wall_ms:.2f} ms/step, device "
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
    from repro_torch.kernels import _build, fused_kernel, ops, \
        penalty_kernel, shvs_kernel
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
    steps = profile_steps(dev, card)

    launch_of = {"penalty_scale": counts["shvs"]["penalty_scale"],
                 "shvs_masses": counts["shvs"]["shvs_masses"],
                 "fused_sample": counts["fused"]["fused_sample"]}
    kernels = []
    for mod in (penalty_kernel, shvs_kernel, fused_kernel):
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
