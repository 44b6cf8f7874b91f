#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the exit code is then non-zero):

1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc
   per source, in parallel), printing the nvcc commands and ptxas lines,
   then, where the toolkit has ``cuobjdump``, ``gumbel_argmax_kernel``'s
   registers, stack and local memory and the instructions of its float4
   loop (the whole SASS goes to ``chiprun_out/gumbel_argmax_kernel.sass``);
2. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes (B = 8, V = 49152, H = 1024, k_cap = 256) and at
   edge shapes (B = 1 and 3, a V no block size divides, τ = 0 rows,
   ±1e4 logits, all-hot and no-hot sets; for ``gumbel_argmax`` -1e30
   entries, a NaN row and seed 324, whose hash gives u == 1.0 at row 0,
   column 32466 of a V = 49152 operand), and time kernel and plain
   version with CUDA events, in turns, after a warm-up, at two shapes:
   the main path's, warm in L2, and B = 64, V = 151936 (qwen3-8b's
   vocabulary), cold: calls rotate over copies of the inputs whose bytes
   exceed twice the L2. Each kernel's record carries its share of its
   bound (bound ms / kernel ms) at both. The cluster split of
   ``shvs_masses``, ``fused_sample`` and ``gumbel_argmax`` is held to its
   hazards (``check_split``, ``check_gumbel_split``), and
   ``gumbel_argmax``'s noise to ``-logf(-logf(u))`` bit for bit at all
   2^32 hash values; its issue floor (SASS instructions a column over the
   schedulers' rate at the SM clock) is printed beside its time.
   ``fused_sample`` past its old K <= 1024 cap: K = 2048, 16384 and the
   padded V at B = 8, V = 49152, and the padded V at B = 8, V = 151936, on
   the path the kernel picks and forced onto its global-workspace path,
   both equal to each other and to the plain version, each timed;
3. hold the port's CUDA forward against its CPU forward on small f32
   models of every served family (the CPU forward is what the tests hold
   against the reference): smollm-360m, granite-moe-1b-a400m at a
   capacity factor of 0.5 (the phase prints the pairs dropped, equal on
   both devices), llama4-maverick-400b-a17b (the shared expert),
   rwkv6-3b and zamba2-1.2b, logits and every cache leaf;
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
   device busy time and idle share, launches per step), and of the
   ``shvs`` engine with the decision on the host (``sampler_mode="host"``,
   2 workers), whose row adds the pool's stall per step;
6. host placement, at full width through ``build_engine``: the same 8
   seeded requests of 16 new tokens (``shvs``, contiguous, overlapped)
   served with the decision on the device and in the host sampler pool (2
   workers), in turns (device, host, device, host), printing tok/s, TTFT
   and TPOT p50 and, for the host runs, the pool's transfer, sampler and
   stall ms per step; the host runs' decode steps launch no decision
   kernel (``penalty_scale`` and ``shvs_masses`` count the prefill draws
   only, the device runs also every decode step); runs of one placement
   give equal streams, and the agreement across placements is printed
   (the card's kernels and the pool's CPU versions may round sums
   differently); greedy ``shvs`` host ≡ device, and greedy ``gumbel`` on
   the paged, chunked, preempting path host ≡ device; a greedy run
   switched device → host → device mid-generation ≡ the all-device run;
   ``sampler_mode="adaptive"`` on 24 requests finishes every request and
   prints the controller's decisions; three steady-state host-mode steps
   make no synchronising call; then the pool alone, on logits made on the
   card from a seed, at B = 8, V = 49152 and B = 64, V = 151936, 20
   submits each at 1, 2, 4 and 8 workers (capped at ``os.cpu_count()``):
   median transfer and sampler ms, tokens equal across worker counts;
7. the pipeline engine at full width and half depth (16 of smollm-360m's 32
   layers, to leave the script's time to phase 9) through ``build_engine``
   (``shvs``, batch 8): (p, M) = (2, 2), (2, 4), (4, 4), (4, 8), each with
   the decision in the host pool (``disaggregated``, 2 workers) and drawn
   on the card after the last stage (``baseline``), the paged cache at (2,
   4) in both modes, and ``fused`` with k_cap = 2048 in ``baseline``; for
   each, tok/s, TTFT and TPOT p50, ``pipeline_report()`` (Eq. 4's cycle
   time C and bubble fraction for p separate cards, from the measured stage
   times), the wall time of a cycle on this card, and the launches of
   ``penalty_scale``, ``shvs_masses`` and ``fused_sample`` (one draw an
   admission, and in ``baseline`` one a commit); greedy streams equal the
   single-stage engine's up to a first difference where the top-two logit
   gap is below ``GAP_CLEAR``; then the pool alone at the microbatches' R =
   4, 2, 1 rows over 1–8 workers.

8. KV migration, the prefill/decode handoff and the gateway, at full
   width (smollm-360m, bf16, batch 8, max_seq 256, one parameter tree for
   every engine of the phase): (a) one request mid-decode exported from a
   contiguous and from a paged engine: its K/V equal the cache rows bit
   for bit, ``to_bytes`` -> ``from_bytes`` keeps the bf16 bits, and the
   importing engine's K/V and histogram rows are the payload's; export,
   bytes and import timed; (b) ``HandoffScheduler`` (a prefill and a
   decode engine) on ``shvs`` contiguous, ``shvs`` paged and ``gumbel``
   paged with chunked prefill (64) and long prompts, 8 requests of 16
   tokens, seeded-sampled and greedy: every request migrates, the
   streams equal the never-migrated engine's (a first difference only
   where the top-two logit gap is below ``GAP_CLEAR``, counted), the
   decision kernels launch, and per request the export and import ms,
   KV bytes and handoff wait from the ``kv_migrate``/``handoff_wait``
   spans; (c) ``GatewayServer`` on 127.0.0.1:0 with 8 concurrent
   ``stream_completion`` clients over 1 replica, 2 replicas and a
   1 prefill + 1 decode paged fleet: wire streams equal one engine's
   in-process streams (same rule), wire TTFT and TPOT p50
   (``summarize_traces``), each replica's stats and ``migration_stats()``
   and the decision kernels' launches.

9. the MoE, RWKV-6 and Zamba2 families at full width, one at a time
   (granite-moe-1b-a400m 24 L, d 1024, 32 experts top-8, V = 49155;
   rwkv6-3b 32 L, d 2560, V = 65536; zamba2-1.2b 38 L, d 2048, V = 32000;
   bf16 seeded weights through ``build_engine``, batch 8, max_seq 256, H =
   min(1024, V/4), k_cap 256): (a) ``shvs`` and ``fused``, 8 seeded
   requests of 16 new tokens: every request finishes with its length, two
   runs equal, overlapped ≡ sequential, the decision kernels launch, three
   steady-state steps make no synchronising call, and greedy
   ``shvs``/``fused`` equal ``reference`` up to a first difference at a
   top-two gap below ``GAP_CLEAR``; (b) prefill(T-3) + 3 teacher-forced
   decode steps against prefill(T) through ``Model``, in bf16 and in f32
   (MoE at capacity_factor = E, as the reference's consistency test runs):
   the max relative error of the logits (below 1e-3 in f32), equal argmax
   where the gap is clear; (c) granite on the paged cache (16 blocks of 16,
   preempting) with chunked prefill (64), ``gumbel`` and long prompts: two
   runs equal, ``gumbel_argmax`` and ``penalty_scale`` launch at V = 49155,
   greedy paged vs contiguous agreement and the pairs dropped printed; (d)
   granite through ``PipelineEngine`` at (2, 4): at the config's capacity
   factor (``baseline``) the agreement with the single-stage engine and the
   drops are printed (2-row admissions drop other pairs than 8-row ones);
   at capacity_factor = E, ``baseline`` and ``disaggregated``, the gap rule
   holds; (e) rwkv6-3b and zamba2-1.2b refuse ``cache="paged"`` and serve
   ``prompt_chunk=64`` monolithically, streams equal the unchunked run's;
   (f) a step profile of each family's ``shvs`` engine (as phase 5, plus
   launches a layer, the weight-bytes floor and ``Model.prefill`` ms at B =
   8, Sp = 32).

10. the training path, the VLM and audio inputs and chunked attention,
   at full width (bf16 seeded weights): (a) smollm-360m (32 L, V = 49152)
   trained by ``Trainer`` for 25 steps on seeded synthetic Zipf batches
   (B = 8, S = 128, remat, AdamW with f32 moments, the reference's
   ``TrainConfig`` at rate 1e-3 and warmup 5): per step the loss, the
   gradient norm, ms and tokens/s; the peak memory and, over one more
   step under torch.profiler, launches and device time a step; every
   loss finite and the last below the first; the first batch's loss
   equal and its gradients within ``REMAT_GRAD_TOL`` with remat off and
   on; a checkpoint saved and restored bit for bit; the restored and the
   in-memory parameters serve 8 greedy requests through ``Engine``
   (``shvs``, ``fused``) with equal streams and the decision kernels
   launched; (b) one train step at B = 1, S = 4096 that reaches
   ``attend_chunked`` in every layer's forward and recompute (ms, peak
   memory), and a prefill at S = 4608 in f32, chunked against
   ``attend_full``: the logits' and the K/V cache's max relative error
   below ``CHUNK_REL_TOL`` and argmax equal where the top-two gap is
   clear; (c) internvl2-2b (24 L, d 2048, V = 92553, untied head) served
   text only through ``Engine`` (``shvs`` and ``fused``: two runs equal,
   the kernels launched at V = 92553, greedy ≡ ``reference`` up to the gap
   rule), 256 seeded patch embeddings + 32 tokens through
   ``Model.prefill`` and 16 decode steps drawn by ``DecisionPlane.step``,
   and a train step with the patches; (d) whisper-base (6 + 6 L, d 512, V
   = 51865): the encoder's ms over 1,500 seeded frames, prefill + 16
   decode steps drawn by ``DecisionPlane.step``, prefill(21) + 3 decode
   against prefill(24) in f32 and bf16 (phase 9 (b)'s check), a train
   step with the frames, and the engine's refusal (ROADMAP Fault 7).
11. distribution: each kernel against its plain version at the shapes a
   rank gives it (S1 rows (2, 49152), data rows (4 and 8, 49152),
   hierarchical blocks (8, 12288) and (4, 24576); ``gumbel_argmax`` of
   rows from ``row0`` on ≡ those rows of the whole batch's) and timed at
   (2, 49152) and (8, 12288); (a) a (1, 1) mesh over NCCL in this process
   serves full-width smollm-360m, batch 8, unfiltered and greedy rows,
   with the plane in each of the three modes: the streams equal the run
   without a mesh; (b) four ranks spawned on this card over gloo (the
   kernel library built before, so they only load it), on (1, 4) and
   (2, 2) meshes: the rank's blocks of smollm-360m's decode logits
   (prefill of 32 tokens + 3 greedy steps at B = 8, full width) through
   S1 with ``shvs``, ``fused`` and ``gumbel``, ``vocab_gather`` and
   ``hierarchical`` (unfiltered and greedy rows against ``shvs``,
   filtered rows against ``truncation_first``), 4 steps each: tokens and
   histograms equal the single-device plane's bit for bit on every rank,
   each path's kernels launched on every rank (counts reset just before
   the timed steps); granite-moe-1b-a400m at full width with each rank's
   expert block decodes 4 greedy tokens through the EP MoE (the path
   ``_prefer_scatter`` picks printed), held to the single-process engine
   under the gap rule, and its MoE layer alone in f32 within 2e-4 (abs +
   rel) of the local path. Each rank's step ms and collective ms (host
   clock, the device synchronised around each collective), the bytes a
   mode moves (reckoned from the shapes), and the collectives gloo
   refused for CUDA tensors and that were staged through pinned host
   memory are printed. Four ranks share one card: no time here is a
   time across cards.
12. tensor-parallel serving (``launch/steps.py``'s programs, the model
   forward split over the model axis): (a) under a (1, 1) mesh over NCCL
   in this process, smollm-360m's prefill program and 8 serve-step
   programs (full width, B = 8, S1 ``shvs``, mixed rows) equal the same
   programs without a mesh bit for bit; (b) four ranks spawned on this
   card over gloo at (1, 4) and (2, 2) run smollm-360m at full width and
   depth (bf16, seeded weights, each rank its blocks), B = 8, a 64-token
   prompt and a cache of 256 (the reference's ``SHAPES`` cut): the
   prefill program, then 8 serve-step programs fed the single-process
   tokens (teacher-forced, so the logits stay comparable), with ``shvs``
   and at (1, 4) also ``fused`` and ``gumbel``, so every kernel runs
   inside a TP serve step; (c) the same at (1, 4) for granite-moe-1b-a400m
   (8 of 24 layers), rwkv6-3b (8 of 32) and zamba2-1.2b (12 of 38, in
   float32: seeded in bf16 its logits move by O(1) under any change of
   rounding order, phase 9 (b)), 3 serve steps. Per rank: the max abs difference of its logits block from
   the single-process block, greedy tokens equal where the top-two gap is
   at least ``GAP_CLEAR``, weight bytes equal to ``param_spec``'s
   reckoning (and the whole model's beside them), cache bytes at most
   ``cache_shardings``', ``max_memory_allocated``, the step's median ms,
   its collectives' count and ms (``dist.set_timing``), the decision
   kernels' launches, and the analytic bound of the step
   (``launch/hlo_analysis``, H100 SXM5 constants) beside it. The ranks'
   logs go to ``chiprun_out/tp_rank*.log``. Four ranks share one card: no
   time here is a time across cards.
13. the train-step program under a mesh: (a) one step of
   ``launch/steps.make_train_step_program`` of full-width smollm-360m
   (bf16, B = 8, S = 128, phase 10 (a)'s batch) on a (1, 1) NCCL mesh
   equals the program without a mesh bit for bit (loss, grad norm, every
   parameter and moment); (b) four gloo ranks on this card at (1, 4) and
   (2, 2), full width and depth, three steps from one init and the same
   seeded batches against the single process on this card, and
   granite-moe-1b-a400m (8 of 24 layers) at (1, 4) through the EP MoE.
   Per rank: the loss and grad norm and their relative errors, the
   parameter blocks after step 1 (within 2·lr plus one bf16 rounding),
   the weight and AdamW-moment bytes against ``sharding.rank_bytes``, the
   step's ms, its collectives' count and ms by phase (forward, backward,
   remat's re-run, the gradient sum, the norm, the metrics;
   ``dist.phase_stats`` with ``dist.set_timing``), peak memory; the ranks'
   logs go to ``chiprun_out/mt_rank*.log``; (c) ``python -m
   repro_torch.launch.dryrun --device cuda`` (the programs traced as rank
   0 of 512 on fake CUDA tensors) for smollm-360m's train_4k, decode_32k
   and long_500k on 16×16 and decode_32k on 2×16×16, granite's train_4k
   and rwkv6-3b's decode_32k (40 heads over 16 ranks), side by side,
   started first at the lowest CPU priority (``nice`` 19) and run beside
   (a), (b) and (d) on the cores those leave idle, every record ``ok``
   (their logs go to
   ``chiprun_out/mt_dryrun_*.log``); then a fake CUDA tensor launches no
   kernel and a real one launches each once; (d) each
   ``examples/torch_*.py`` on the card at small arguments (the train
   example 20 steps of 2 rows of 32 tokens, so its warmup moves the loss),
   in this process, with its decision kernels' launches.
14. degenerate decision rows (``tests/torch_degenerate_rows.py``, the
   fixture the CPU tests hold to the reference): (a) every kernel against
   its plain version, row by row, on each of its cases (``top_p`` 0 and
   -0.5, ``min_p`` 1.5, 2 and 1, τ 1e-30 and NaN, repetition 0 with
   counts, a NaN column in the first, a middle and the last CTA's range,
   an all-NaN and an all -inf row, a +inf column, rows with fewer and
   more finite values than K) at (8, 49152), (64, 151936) and (8, 50021),
   ``fused_sample`` at k_cap 256 and 2048 on the path it picks and on the
   global path, and ROADMAP Fault 10's probe (B = 3, V = 1000, k_cap 64,
   ``min_p`` = 2: nothing kept, the draw in bounds); (b) full-width
   smollm-360m with ``fused`` on the contiguous and the paged cache
   serves 8 requests, ``top_p = 0`` and ``min_p = 2`` ones beside their
   greedy twins and ordinary ones, with the launch counters reset just
   before: where nothing is kept the draw is the top penalised logit, so
   each degenerate stream equals its twin's; then a later batch on the
   same CUDA context; (c) the gateway over one such replica: ``"top_p":
   0`` and ``"min_p": 2`` get 200 and the greedy twin's stream. It prints
   each kernel's and case's result and raises after the report if any
   row differs.

``python3 chip_smoke.py --families-only`` builds the kernels and runs
phases 3 and 9 alone, printing one JSON line. ``--train-only`` runs
phase 10 alone the same way, ``--dist-only`` phase 11, ``--tp-only``
phase 12, ``--mesh-train-only`` phase 13 and ``--degenerate-only``
phase 14.

``python3 chip_smoke.py --host-only`` builds the kernels and runs phase 5's
``shvs`` rows on the device and in the host pool, in turns, and the pool
alone at the main shape, printing one JSON line: run it under different
threading settings, one process each.

``python3 chip_smoke.py --pipeline-only`` builds the kernels and runs phase
7 alone, printing one JSON line: run it under torch's default threads and
under ``OMP_NUM_THREADS=1``, one process each. ``--migration-only`` runs
phase 8 alone the same way.

``python3 chip_smoke.py --time-only [--src DIR]`` builds and runs phase 2's
timing alone, of the package under DIR (default ``src``), and prints one
JSON line: two trees are compared in one call by running it on each, in
turns.

The last two lines of standard output are the ``kernels`` JSON object and
``{"ok": true, "device": {...}}``. A longer report goes to
``chiprun_out/chip_smoke_report.json``. Imports torch and the port only.
"""
from __future__ import annotations

import contextlib
import copy
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
B_LARGE, V_LARGE = 64, 151936  # an HBM-sized shape: qwen3-8b's vocabulary
V_ODD = 50021                  # divisible by no power-of-two block
PAGED = dict(cache="paged", block_size=16, num_blocks=16, prompt_chunk=64)
PAGED_NEW = 32                 # new tokens a request on the paged path
U_ONE_SEED, U_ONE_COL = 324, 32466   # hash(324, 0, 32466) rounds to u = 1
# (B, V) of check_gumbel_split -> (seed, column): the hash gives u == 1.0
# at that column of row B - 1 and at no lower column of that row
GUMBEL_U_ONE = {(8, 300): (54539826, 226), (8, 2049): (4864, 1572),
                (3, 4100): (280, 629), (8, 50021): (347, 15666),
                (1, 49152): (324, 32466), (8, 49152): (347, 15666),
                (64, 151936): (170, 142141)}
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
    errors, and timings and bounds at the main and the large shape."""
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

    check_split(gen, dev, err)
    check_gumbel_split(gen, dev)
    large_k = check_fused_large_k(gen, dev, err)
    timing = {"main": time_kernels(B_MAIN, V_MAIN, gen, dev, 1, 1),
              "large": time_kernels(B_LARGE, V_LARGE, gen, dev, 3, 2)}
    bounds = {"main": kernel_bounds(B_MAIN, V_MAIN),
              "large": kernel_bounds(B_LARGE, V_LARGE)}
    return err, timing, bounds, large_k


def check_fused_large_k(gen, dev, err):
    """Phase 2, ``fused_sample`` past its old K <= 1024 cap: at B = 8, V =
    49152 with K = 2048, 16384 and the padded V, and at B = 8, V = 151936
    with K = the padded V, the kernel on the path it picks (shared memory
    up to K = 16384 here, the global workspace beyond) and forced onto the
    global path: both equal each other bit for bit and the plain version
    in tokens and alpha (rtol 1e-5); kept and exact where the kept mass
    stays clear of 1.0 (ROADMAP 'Faults' 1: every row while K < padded V,
    rows with an explicit top_k at K = padded V). Each is timed in turns
    with the plain version, warm in L2 (ms on the device)."""
    import torch
    from repro_torch.kernels import fused_kernel, ref
    out = []
    for B, V, k_cap in ((B_MAIN, V_MAIN, 2048), (B_MAIN, V_MAIN, 16384),
                        (B_MAIN, V_MAIN, None), (B_MAIN, V_LARGE, None)):
        Vp = -(-V // BLOCK_V) * BLOCK_V
        K = Vp if k_cap is None else k_cap
        x = make_inputs(B, V, gen, dev, tau_zero=(3,))
        hot = hot_mask(V, "first", dev)
        args = (x["z"], x["cp"], x["co"], x["rep"], x["pres"], x["freq"],
                x["temp"], x["top_k"], x["top_p"], x["min_p"], x["u"], hot)
        want = ref.fused_sample_ref(*args, k_cap=K, block_v=BLOCK_V)
        clear = x["top_k"] > 0 if K == Vp else \
            torch.ones(B, dtype=torch.bool, device=dev)
        rec = {"B": B, "V": V, "K": K}
        for path in (None, "global"):
            split = fused_kernel.split(B, Vp, K, path)
            got = fused_kernel.fused_sample(*args, k_cap=K, block_v=BLOCK_V,
                                            path=path)
            torch.cuda.synchronize()
            assert torch.equal(got[0], want[0]), (
                f"fused_sample tokens differ at B={B} V={V} K={K} "
                f"({split['path']}): {got[0].tolist()} vs {want[0].tolist()}")
            torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=0)
            for name, i in (("exact", 1), ("kept", 3)):
                assert torch.equal(got[i][clear], want[i][clear]), (
                    f"fused_sample {name} differ at B={B} V={V} K={K} "
                    f"({split['path']})")
            if path is None:
                auto = got
            else:
                assert all(torch.equal(a, g) for a, g in zip(auto, got)), \
                    f"the two paths differ at B={B} V={V} K={K}"
            err["fused_sample"] = max(err["fused_sample"],
                                      (got[2] - want[2]).abs().max().item())
            k_ms, p_ms, launch_ms, _ = time_in_turns(
                f"fused_sample K={K}",
                lambda: fused_kernel.fused_sample(*args, k_cap=K,
                                                  block_v=BLOCK_V, path=path),
                lambda: ref.fused_sample_ref(*args, k_cap=K, block_v=BLOCK_V),
                n_kernel=10, n_plain=1, rounds=3)
            rec[split["path"] if path is None else "forced_global"] = {
                "split": split, "ms": k_ms, "launch_ms": launch_ms}
            rec["plain_ms"] = p_ms
        rec["bound_ms"] = kernel_bounds(B, V)["fused_sample"][0]
        out.append(rec)
        picked = "shared" if "shared" in rec else "global"
        print(f"kernel check fused_sample B={B} V={V} K={K}: {picked} path "
              f"(L {rec[picked]['split']['L']}, smem "
              f"{rec[picked]['split']['smem_bytes']} B) "
              f"{rec[picked]['ms']:.4f} ms, forced global path "
              f"{rec['forced_global']['ms']:.4f} ms (workspace "
              f"{rec['forced_global']['split']['workspace_keys'] * 8} B), "
              f"plain {rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.5f} "
              f"ms; both paths equal the plain version: ok")
    return out


def check_split(gen, dev, err):
    """Phase 2, the cluster split of ``shvs_masses`` and ``fused_sample``:
    a CTA with fewer than K columns (V = 2049 and 4100 as one tile: CTAs
    of 2048 and 1 columns, and of 2048, 2048, 4 and 0; V = 300 stays on
    one CTA, as no CTA but the last gets fewer than 2048 columns), rows
    that are not 16-byte aligned (V odd), equal maxima placed in
    different CTAs' ranges on a τ = 0 row (the lowest column must win), an
    all-equal row, -1e30 entries, a top_k = 1 row, B = 1 and B = 64 × V =
    151936; and two launches on the same inputs give the same bits."""
    import torch
    from repro_torch.kernels import fused_kernel, ref, shvs_kernel
    for B, V, block_v in ((8, 300, BLOCK_V), (8, 2049, 2049),
                          (3, 4100, 4100), (B_MAIN, V_ODD, BLOCK_V),
                          (1, V_MAIN, BLOCK_V), (B_MAIN, V_MAIN, BLOCK_V),
                          (B_LARGE, V_LARGE, BLOCK_V)):
        Vp = -(-V // block_v) * block_v
        sf = fused_kernel.split(B, Vp, min(K_CAP, Vp))
        ss = shvs_kernel.split(B, V)
        x = make_inputs(B, V, gen, dev, tau_zero=(0,))
        ties = hazard_rows(x, V, sf["chunk"], sf["C"])
        hot = hot_mask(V, "first", dev)
        pen = (x["z"], x["cp"], x["co"], x["rep"], x["pres"], x["freq"],
               x["temp"])
        zs = ref.penalty_ref(*pen)
        got = shvs_kernel.shvs_masses(zs, hot)
        again = shvs_kernel.shvs_masses(zs, hot)
        want = ref.shvs_mass_ref(zs, hot)
        torch.cuda.synchronize()
        assert all(torch.equal(g, a) for g, a in zip(got, again)), \
            f"shvs_masses: two launches differ at B={B} V={V}"
        assert torch.equal(got[0], want[0]) and torch.equal(got[3], want[3]), \
            f"shvs_masses m/tail_max differ at B={B} V={V}"
        for g, w in zip(got[1:3], want[1:3]):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=0)
        err["shvs_masses"] = max(err["shvs_masses"], max(
            (g - w).abs().max().item() for g, w in zip(got, want)))
        f_args = pen + (x["top_k"], x["top_p"], x["min_p"], x["u"], hot)
        got = fused_kernel.fused_sample(*f_args, k_cap=K_CAP, block_v=block_v)
        again = fused_kernel.fused_sample(*f_args, k_cap=K_CAP,
                                          block_v=block_v)
        want = ref.fused_sample_ref(*f_args, k_cap=K_CAP, block_v=block_v)
        torch.cuda.synchronize()
        assert all(torch.equal(g, a) for g, a in zip(got, again)), \
            f"fused_sample: two launches differ at B={B} V={V}"
        for name, i in (("tokens", 0), ("exact", 1), ("kept", 3)):
            assert torch.equal(got[i], want[i]), (
                f"fused_sample {name} differ at B={B} V={V} "
                f"block_v={block_v}: {got[i].tolist()} vs {want[i].tolist()}")
        torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=0)
        err["fused_sample"] = max(err["fused_sample"],
                                  (got[2] - want[2]).abs().max().item())
        assert int(got[0][0]) == ties[0], \
            ("the lowest of the equal maxima must win", ties, got[0][0])
        print(f"split check B={B} V={V} block_v={block_v}: shvs_masses C="
              f"{ss['C']} grid {ss['grid']} chunk {ss['chunk']}; "
              f"fused_sample C={sf['C']} grid {sf['grid']} chunk "
              f"{sf['chunk']} smem {sf['smem_bytes']} B; equal maxima at "
              f"columns {ties} (row 0 took {int(got[0][0])}); two launches "
              f"bit-equal: ok")


def check_gumbel_split(gen, dev):
    """Phase 2: ``gumbel_argmax``'s noise against ``-logf(-logf(u))`` at
    every hash value, then its cluster split at V = 300 (one CTA), 2049
    and 4100 (CTAs of fewer than 2048 columns, or none), 50021 (rows not
    16-byte aligned), B = 1, the main shape and B = 64 × V = 151936: row 0
    holds +inf at column 3 of every CTA's range (the lowest must win), row
    1 NaNs in two or three CTAs' ranges (the first must win; V = 300 has
    one CTA, which gets two), row 2 -1e30 on its first two thirds; then an
    operand of -1e30 rows under a seed whose hash gives u == 1.0 in the
    last row (``GUMBEL_U_ONE``), whose column must win; two launches must
    give equal tokens."""
    import torch
    from repro_torch.kernels import gumbel_kernel, ref
    bad = gumbel_kernel.noise_check(dev)
    assert bad == 0, f"gumbel noise differs from -logf(-logf(u)) at {bad} " \
        "hash values"
    print("gumbel_argmax noise ≡ -logf(-logf(u)) bit for bit at all 2^32 "
          "hash values: ok")
    for B, V in GUMBEL_U_ONE:
        sg = gumbel_kernel.split(B, V)
        C, chunk = sg["C"], sg["chunk"]
        z = torch.randn((B, V), generator=gen, device=dev) * 2.0
        infs = sorted({min(r * chunk + 3, V - 1) for r in range(C)})
        z[0, infs] = float("inf")
        nans = sorted({min(r * chunk + 5, V - 1) for r in {C // 2, C - 1}}
                      | {min(max(C // 2 - 1, 0) * chunk + 9, V - 1)})
        if B > 1:
            z[1, nans] = float("nan")
        if B > 2:
            z[2, :2 * V // 3] = -1e30
        got = gumbel_kernel.gumbel_argmax(z, 1234)
        again = gumbel_kernel.gumbel_argmax(z, 1234)
        want = ref.gumbel_argmax_ref(z, 1234)
        torch.cuda.synchronize()
        assert torch.equal(got, again), \
            f"gumbel_argmax: two launches differ at B={B} V={V}"
        assert torch.equal(got, want), (
            f"gumbel_argmax differs at B={B} V={V}: {got.tolist()} vs "
            f"{want.tolist()}")
        assert int(got[0]) == infs[0], ("the lowest +inf must win", infs,
                                        int(got[0]))
        if B > 1:
            assert int(got[1]) == nans[0], ("the first NaN must win", nans,
                                            int(got[1]))
        seed, col = GUMBEL_U_ONE[B, V]
        u = ref._hash_uniform(seed, torch.tensor(B - 1), torch.arange(V))
        assert float(u[col]) == 1.0 and not bool((u[:col] == 1.0).any())
        z = torch.full((B, V), -1e30, device=dev)
        got = gumbel_kernel.gumbel_argmax(z, seed)
        want = ref.gumbel_argmax_ref(z, seed)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and int(got[-1]) == col, (
            f"gumbel_argmax u == 1.0 at B={B} V={V} seed={seed}: "
            f"{got.tolist()} vs {want.tolist()}, column {col}")
        print(f"split check gumbel_argmax B={B} V={V}: C={C} grid "
              f"{sg['grid']} chunk {chunk} threads {sg['threads']} "
              f"(clusters resident at once: {sg['max_active_clusters']}); "
              f"+inf at columns {infs[:4]}"
              f"{'...' if len(infs) > 4 else ''} (row 0 took "
              f"{infs[0]}); NaN at {nans if B > 1 else '-'}; u == 1.0 in a "
              f"-1e30 row at column {col} (seed {seed}); two launches "
              f"equal: ok")


def hazard_rows(x, V, chunk, C):
    """Rewrite rows of the inputs ``x`` in place: row 0 (τ = 0) gets equal
    maxima at column 3 of each CTA's range, with zero counts there; row 1
    is all equal with zero counts; row 2 has -1e30 on its first two
    thirds; the last row takes top_k = 1. Returns row 0's tied columns."""
    B = x["z"].shape[0]
    ties = sorted({min(r * chunk + 3, V - 1) for r in range(C)})
    x["z"][0, ties] = 30.0
    x["cp"][0, ties] = 0
    x["co"][0, ties] = 0
    if B > 1:
        x["top_k"][-1] = 1
    if B > 2:
        x["z"][1] = 0.25
        x["cp"][1] = 0
        x["co"][1] = 0
    if B > 3:
        x["z"][2, :2 * V // 3] = -1e30
    return ties


def time_kernels(B, V, gen, dev, z_copies, set_copies):
    """Kernel and plain-version times of the four kernels at (B, V), H =
    1024, k_cap = 256. With one copy the inputs stay warm in the 50 MB L2,
    as the decode step finds the logits the LM head has just written.
    Otherwise each call takes the next of ``z_copies`` copies of z
    (``shvs_masses``, ``gumbel_argmax``) or of ``set_copies`` copies of
    (z, counts_p, counts_o) (``penalty_scale``, ``fused_sample``), so that
    the rotation's bytes exceed twice the L2 and every call reads HBM."""
    import itertools
    import torch
    from repro_torch.kernels import (fused_kernel, gumbel_kernel,
                                     penalty_kernel, ref, shvs_kernel)
    sets = [make_inputs(B, V, gen, dev) for _ in range(max(z_copies,
                                                           set_copies))]
    hot = hot_mask(V, "first", dev)
    # the shell's τ = 1 penalty pass, and the scaled logits the samplers see
    pen = [(x["z"], x["cp"], x["co"], x["rep"], x["pres"], x["freq"],
            torch.ones_like(x["temp"])) for x in sets[:set_copies]]
    fus = [p[:6] + (x["temp"], x["top_k"], x["top_p"], x["min_p"], x["u"],
                    hot) for p, x in zip(pen, sets)]
    zs = [ref.penalty_ref(x["z"], x["cp"], x["co"], x["rep"], x["pres"],
                          x["freq"], x["temp"]) for x in sets[:z_copies]]

    def turn(items):
        it = itertools.cycle(items)
        return lambda: next(it)

    nz, nset = turn(zs), turn(range(set_copies))
    timing = {}
    timing["penalty_scale"] = time_in_turns(
        "penalty_scale", lambda: penalty_kernel.penalty_scale(*pen[nset()]),
        lambda: ref.penalty_ref(*pen[nset()]))
    timing["shvs_masses"] = time_in_turns(
        "shvs_masses", lambda: shvs_kernel.shvs_masses(nz(), hot),
        lambda: ref.shvs_mass_ref(nz(), hot))
    # the plain version makes ~16 launches a tile: one call per
    # measurement keeps the queue below the device's depth limit
    timing["fused_sample"] = time_in_turns(
        "fused_sample",
        lambda: fused_kernel.fused_sample(*fus[nset()], k_cap=K_CAP,
                                          block_v=BLOCK_V),
        lambda: ref.fused_sample_ref(*fus[nset()], k_cap=K_CAP,
                                     block_v=BLOCK_V),
        n_kernel=50, n_plain=1)
    timing["gumbel_argmax"] = time_in_turns(
        "gumbel_argmax", lambda: gumbel_kernel.gumbel_argmax(nz(), 1234),
        lambda: ref.gumbel_argmax_ref(nz(), 1234))
    return timing


def kernel_bounds(B, V):
    """Least time for each kernel's work at (B, V): each input read once,
    each output written once, over the memory rate; element operations
    over the f32 rate (rough counts: the byte bound is larger by two
    orders). Returns {name: (ms, "bytes" | "operations", bytes)}."""
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
    return bounds


# phase 3's reduced f32 models: (arch, MoE capacity factor or None); the
# lowered factor makes granite's prefill drop pairs
MODEL_CHECKS = (("smollm-360m", None), ("granite-moe-1b-a400m", 0.5),
                ("llama4-maverick-400b-a17b", None), ("rwkv6-3b", None),
                ("zamba2-1.2b", None))


def with_capacity(cfg, factor):
    """``cfg`` with its MoE capacity factor set to ``factor``."""
    import dataclasses
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=factor))


@contextlib.contextmanager
def counted_drops(*engines):
    """Counts the (token, k) pairs every MoE call of the block routes and
    drops past capacity (reads each call's count back: not for timed
    runs). A decode step replayed as a CUDA graph makes no call to count
    and a capture cannot read one back, so ``engines`` step eagerly (the
    engine's private switch)."""
    from repro_torch.models import moe
    for eng in engines:
        eng._graph_device = False
    slots = moe._slots
    n = {"pairs": 0, "dropped": 0}

    def counting(ids_flat, num_experts, capacity):
        out = slots(ids_flat, num_experts, capacity)
        n["pairs"] += ids_flat.numel()
        n["dropped"] += int((~out[2]).sum())
        return out

    moe._slots = counting
    try:
        yield n
    finally:
        moe._slots = slots


def check_model(dev):
    """Phase 3: the CUDA forward against the CPU forward on reduced f32
    models (right-padded prefill + 3 decode steps): logits and every cache
    leaf at 1e-4, and MoE drops equal on both devices. Returns the max
    abs error per arch."""
    import torch
    from repro_torch.config import get_arch
    from repro_torch.models.model import Model
    out = {}
    for arch, factor in MODEL_CHECKS:
        cfg = get_arch(arch).reduced()
        if factor is not None:
            cfg = with_capacity(cfg, factor)
        model = Model(cfg)
        params_cpu = model.init(seed=5, device="cpu")
        to = lambda t, d: {k: to(v, d) if isinstance(v, dict) else v.to(d)
                           for k, v in t.items()}
        gen = torch.Generator().manual_seed(3)
        toks = torch.randint(0, cfg.vocab_size, (3, 20), generator=gen,
                             dtype=torch.int32)
        lens = torch.tensor([20, 11, 7], dtype=torch.int32)
        steps = torch.randint(0, cfg.vocab_size, (3, 3), generator=gen,
                              dtype=torch.int32)
        runs = []
        for d, p in (("cpu", params_cpu), (dev, to(params_cpu, dev))):
            with counted_drops() as drops:
                cache = model.init_cache(3, 32, device=d)
                logits, cache = model.prefill(p, {"tokens": toks.to(d)},
                                              cache, true_lens=lens.to(d))
                seq = [logits.cpu()]
                for nxt in steps:
                    logits, cache = model.decode_step(p, nxt.to(d), cache)
                    seq.append(logits.cpu())
            runs.append((seq, {k: v.cpu() for k, v in cache.items()},
                         dict(drops)))
        (a, ca, da), (b, cb, db) = runs
        worst = 0.0
        for x, y in list(zip(a, b)) + [(ca[k], cb[k]) for k in ca]:
            assert torch.isfinite(y.float()).all()
            torch.testing.assert_close(y, x, rtol=1e-4, atol=1e-4)
            worst = max(worst, (x.float() - y.float()).abs().max().item())
        assert da == db, (arch, da, db)
        if factor is not None:
            assert da["dropped"] > 0, "the lowered factor was meant to drop"
        out[arch] = worst
        moe = (f"; capacity factor {cfg.moe.capacity_factor}: "
               f"{da['dropped']} of {da['pairs']} (token, k) pairs dropped "
               f"on both devices") if cfg.moe is not None else ""
        print(f"model check {arch} (reduced f32, CUDA vs CPU forward, "
              f"logits and cache leaves {sorted(ca)}): max abs err "
              f"{worst:.3g}{moe}")
    return out


def engine(algorithm, dev, layers=32, **kw):
    """The serve driver's engine (``launch/serve.py build_engine``) for
    full-width smollm-360m: bf16 weights from seed 0, batch 8, max_seq 256,
    H = 1024, k_cap = 256, ``layers`` of its 32 layers; ``kw`` (cache,
    block_size, num_blocks, prompt_chunk) go to ``build_engine``."""
    import dataclasses
    from repro_torch.config import get_arch
    from repro_torch.launch.serve import build_engine
    cfg = dataclasses.replace(get_arch("smollm-360m"), num_layers=layers)
    eng = build_engine(cfg, False, algorithm, B_MAIN, 256, device=dev,
                       **kw)
    cfg = eng.cfg
    assert cfg.num_layers == layers and cfg.d_model == 960 and \
        cfg.vocab_size == V_MAIN and cfg.dtype == "bfloat16"
    assert eng.ecfg.shvs.resolve_hot_size(V_MAIN) == H_MAIN and \
        eng.decision.k_cap == kw.get("k_cap", K_CAP)
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


def step_profile(eng, reqs):
    """A steady-state decode step of ``eng`` serving ``reqs``: 6 steps of
    warm-up (admission included), 10 timed on the host clock, 5 under
    torch.profiler. Returns (record, the timed steps' ``StepRecord``s):
    host wall ms a step, device busy ms a step (kernel times by name),
    the idle share, launches a step and the decision kernels' ms a
    step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    eng.submit(reqs)
    for _ in range(6):
        eng.step()
    torch.cuda.synchronize()
    n = 10
    mark = len(eng.stats_log)
    t0 = time.perf_counter()
    for _ in range(n):
        eng.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / n * 1e3
    window = list(eng.stats_log)[mark:]
    n_prof = 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            eng.step()
        torch.cuda.synchronize()
    eng.flush()
    busy_ms, launches, ours = profile_totals(prof, n_prof)
    return {"wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms,
            "launches_per_step": launches,
            "decision_kernels_ms_per_step": ours}, window


def profile_totals(prof, n):
    """From a torch.profiler run over ``n`` steps: device busy ms, kernel
    launches and the decision kernels' ms, each a step."""
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
                    ours[k] = ours.get(k, 0.0) + dev_us / n / 1e3
    return busy_us / n / 1e3, launches / n, ours


def top_kernels(prof, n, k=8):
    """The ``k`` kernels with the most device time in a torch.profiler
    run over ``n`` steps: (name, ms a step, calls a step)."""
    rows = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = evt.self_cuda_time_total
        if dev_us > 0 and not evt.key.startswith("aten::"):
            rows.append((evt.key[:80], dev_us / n / 1e3, evt.count / n))
    return sorted(rows, key=lambda r: -r[1])[:k]


def profile_steps(dev, card, names=None):
    """Phase 5: where a steady-state decode step's time goes on each path
    (full width, batch 8): host wall time per step, device busy time per
    step (sum of kernel times from torch.profiler), the idle share, kernel
    launches per step, and the decision-plane kernels' share. The paged
    row uses the second path's batch and chunk width with a pool that
    holds every slot (no preemption inside the window); its long prompts
    are prefilled before the window. The host-mode row also gives the
    engine's block on the pool's ticket per step (stall) and the wall less
    that block (the engine thread's own work)."""
    from repro_torch.launch.serve import synth_requests
    out = {}
    paths = (("shvs", "shvs", {}), ("fused", "fused", {}),
             ("gumbel_paged", "gumbel",
              dict(cache="paged", block_size=16, prompt_chunk=64)),
             ("shvs_host", "shvs", dict(sampler_mode="host", samplers=2)))
    if names is not None:
        paths = [next(p for p in paths if p[0] == n) for n in names]
    for name, algorithm, kw in paths:
        eng = engine(algorithm, dev, **kw)
        reqs = paged_requests(V_MAIN, max_new=64) if "cache" in kw else \
            synth_requests(8, V_MAIN, 64, seed=0)
        rec, window = step_profile(eng, reqs)
        eng.close()
        out[name] = rec
        wall_ms, busy_ms = rec["wall_ms_per_step"], \
            rec["device_busy_ms_per_step"]
        host = ""
        if kw.get("sampler_mode") == "host":
            mean = lambda k: sum(r[k] for r in window) / len(window)
            rec.update({k + "_per_step": mean(k) for k in
                        ("stall_ms", "sampler_ms", "transfer_ms")})
            rec["wall_less_stall_ms_per_step"] = \
                wall_ms - rec["stall_ms_per_step"]
            host = (f"; pool stall {rec['stall_ms_per_step']:.2f} ms/step, "
                    f"wall less stall {rec['wall_less_stall_ms_per_step']:.2f}"
                    f" ms/step, sampler {rec['sampler_ms_per_step']:.2f} ms, "
                    f"transfer {rec['transfer_ms_per_step']:.2f} ms")
        print(f"step profile {name}: wall {wall_ms:.2f} ms/step, device "
              f"busy {busy_ms:.2f} ms/step (idle share "
              f"{rec['idle_share']:.1%}), {rec['launches_per_step']:.0f} "
              f"launches/step, decision kernels "
              f"{rec['decision_kernels_ms_per_step']}{host} [{card}]")
    return out


def token_agreement(a, b):
    """Share of tokens equal up to each request's first difference, over
    all tokens of two runs of the same requests."""
    same = total = 0
    for ra, rb in zip(a, b):
        n = min(len(ra), len(rb))
        same += next((i for i in range(n) if ra[i] != rb[i]), n)
        total += max(len(ra), len(rb))
    return same / total


def serve_host(dev, card):
    """Phase 6: the decision plane on the host (the sampler pool) against
    the decision on the device, at full width through ``build_engine``."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_batch, synth_requests
    V = V_MAIN
    out, seeded = {}, {"device": [], "host": []}
    for turn, mode in enumerate(("device", "host", "device", "host")):
        eng = engine("shvs", dev, sampler_mode=mode, samplers=2)
        serve_batch(eng, synth_requests(2, V, 2, rng_seed=99, seed=0))  # warm
        admits = [0]
        admit = eng._admit

        def counted(reqs, admit=admit):
            admits[0] += 1
            return admit(reqs)

        eng._admit = counted
        mark = len(eng.stats_log)
        reqs = synth_requests(8, V, 16, seed=0)
        ops.reset_launch_counts()
        rep = serve_batch(eng, reqs)
        counts = ops.launch_counts()
        steps = list(eng.stats_log)[mark:]
        eng.close()
        for r in reqs:
            assert r.finish_reason == "length" and len(r.output) == 16, \
                (mode, r.request_id, r.finish_reason, len(r.output))
            assert all(0 <= t < V for t in r.output)
        # the host runs' decode steps launch no decision kernel: only the
        # prefill draws (one an admission) do; the device runs launch one
        # of each a decode step as well
        want = admits[0] + (len(steps) if mode == "device" else 0)
        assert counts["penalty_scale"] == counts["shvs_masses"] == want, \
            (mode, counts, admits[0], len(steps))
        assert admits[0] > 0
        rep.update(launches=counts, admissions=admits[0],
                   decode_steps=len(steps))
        if mode == "host":
            assert all("stall_ms" in r for r in steps)
            mean = lambda k: sum(r[k] for r in steps) / len(steps)
            rep.update({k: mean(k) for k in
                        ("transfer_ms", "sampler_ms", "stall_ms")})
        seeded[mode].append([r.output for r in reqs])
        out[f"{mode}_run{turn // 2}"] = rep
        pool = (f", pool per step: transfer {rep['transfer_ms']:.3f} ms, "
                f"sampler {rep['sampler_ms']:.3f} ms, stall "
                f"{rep['stall_ms']:.3f} ms" if mode == "host" else "")
        print(f"serve shvs {mode} (turn {turn}): {rep['tok_per_s']:.1f} "
              f"tok/s, TTFT p50 {rep['ttft_p50_ms']:.2f} ms, TPOT p50 "
              f"{rep['tpot_p50_ms']:.2f} ms, launches {counts} over "
              f"{admits[0]} admissions and {len(steps)} decode steps{pool} "
              f"[{card}]")
    for mode in ("device", "host"):
        assert seeded[mode][0] == seeded[mode][1], \
            f"two {mode} runs gave different streams"
    agree = token_agreement(seeded["device"][0], seeded["host"][0])
    out["seeded_host_vs_device_agreement"] = agree
    print(f"seeded shvs: two runs of each placement equal; host vs device "
          f"token agreement {agree:.4f} [{card}]")

    greedy = {}
    for name, algorithm, kw in (
            ("shvs_device", "shvs", {}),
            ("shvs_host", "shvs", dict(sampler_mode="host")),
            ("fused_host", "fused", dict(sampler_mode="host")),
            ("gumbel_paged_device", "gumbel", PAGED),
            ("gumbel_paged_host", "gumbel", dict(PAGED, sampler_mode="host"))):
        eng = engine(algorithm, dev, **kw)
        reqs = paged_requests(V, greedy=True) if "cache" in kw else \
            synth_requests(8, V, 16, greedy=True)
        ops.reset_launch_counts()
        rep = serve_batch(eng, reqs)
        rep["launches"] = ops.launch_counts()
        rep["preemptions"] = eng.scheduler.preemptions
        eng.close()
        if "cache" in kw:
            assert rep["preemptions"] > 0, (name, "the pool was meant to "
                                            "exhaust")
        greedy[name] = [r.output for r in reqs]
        out[f"greedy_{name}"] = rep
    assert greedy["shvs_host"] == greedy["shvs_device"], \
        "greedy shvs: host streams differ from device ones"
    assert greedy["fused_host"] == greedy["shvs_device"], \
        "greedy fused in the pool differs from shvs on the device"
    assert greedy["gumbel_paged_host"] == greedy["gumbel_paged_device"], \
        "greedy gumbel paged: host streams differ from device ones"
    print(f"greedy host ≡ device: shvs contiguous "
          f"({sum(map(len, greedy['shvs_host']))} tokens; fused in the pool "
          f"too) and gumbel paged chunked "
          f"({out['greedy_gumbel_paged_host']['preemptions']} preemptions)")
    for name in greedy:
        print(f"launches, greedy {name}: {out[f'greedy_{name}']['launches']}")

    # device -> host -> device mid-generation, greedy: the all-device run
    eng = engine("shvs", dev)
    reqs = synth_requests(8, V, 16, greedy=True)
    eng.submit(reqs)
    steps, modes = 0, []
    while eng.scheduler.has_work or eng.in_flight:
        eng.step()
        steps += 1
        if steps in (4, 9):
            eng.set_sampler_mode("host" if steps == 4 else "device")
            modes.append((steps, eng.client.mode,
                          eng.pstate.prompt_counts.device.type))
    eng.flush()
    eng.close()
    assert [r.output for r in reqs] == greedy["shvs_device"], \
        "a mid-generation switch moved the greedy streams"
    assert modes == [(4, "host", "cpu"),
                     (9, "device", torch.device(dev).type)], modes
    print(f"mid-generation switch device -> host (step 4) -> device (step "
          f"9): greedy streams ≡ all-device")

    eng = engine("shvs", dev, sampler_mode="adaptive")
    reqs = synth_requests(24, V, 16, seed=0)
    rep = serve_batch(eng, reqs)
    decisions = list(eng._dpc.history)
    eng.close()
    for r in reqs:
        assert r.finish_reason == "length" and len(r.output) == 16
    rep["decisions"] = [{"step": d["step"], "action": d["action"]}
                        for d in decisions]
    out["adaptive"] = rep
    print(f"adaptive, 24 requests: every request finished, "
          f"{rep['tok_per_s']:.1f} tok/s, TPOT p50 {rep['tpot_p50_ms']:.2f} "
          f"ms, decisions {rep['decisions']} [{card}]")

    # host mode's steady state never blocks the engine thread on the
    # stream: the logits' copy is waited on by the workers, the tokens go
    # up with a non_blocking copy, the only wait is on the ticket
    eng = engine("shvs", dev, sampler_mode="host")
    eng.submit(synth_requests(8, V, 8, seed=0))
    eng.step()                  # admission reads the first tokens back
    eng.step()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            eng.step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    eng.flush()
    eng.close()
    print("host overlap check: 3 steady-state steps made no synchronising "
          "call")
    out["pool_alone"] = pool_alone(dev, card)
    return out


def pool_alone(dev, card, n=20,
               shapes=((B_MAIN, V_MAIN), (B_LARGE, V_LARGE))):
    """The sampler pool alone (the paper's sequence-parallel sampling, S1,
    on this machine's CPUs): logits made on the card from a seed, ``n``
    submits at each worker count; median transfer and sampler ms."""
    import os
    import statistics
    import numpy as np
    import torch
    from repro_torch.config import SamplingConfig, SHVSConfig
    from repro_torch.core import penalties as pen
    from repro_torch.core.decision_plane import DecisionPlane
    from repro_torch.core.host_sampler import HostSamplerPool
    from repro_torch.engine.engine import SlotParams
    cpus = os.cpu_count()
    print(f"pool alone: os.cpu_count() {cpus}, torch.get_num_threads() "
          f"{torch.get_num_threads()}")
    out = {"cpu_count": cpus, "torch_threads": torch.get_num_threads()}
    for B, V in shapes:
        gen = torch.Generator(device=dev).manual_seed(B)
        logits = torch.randn((B, V), generator=gen, device=dev) * 1.5
        sp = SlotParams(B, V, "cpu")
        for b in range(B):
            sp.set_row(b, SamplingConfig(temperature=0.8, top_k=40,
                                         top_p=0.95, repetition_penalty=1.1,
                                         seed=b))
        z = torch.zeros((B, V), dtype=torch.int32)
        args = (logits, pen.PenaltyState(z, z.clone()), sp.host_params(),
                None, np.arange(B, dtype=np.uint32), np.zeros(B, np.int32),
                0, np.ones(B, bool))
        plane = DecisionPlane(V, algorithm="shvs",
                              shvs=SHVSConfig(hot_size=H_MAIN), k_cap=K_CAP,
                              seed=0, device=dev)
        tokens, rows = None, {}
        for workers in sorted({min(w, cpus) for w in (1, 2, 4, 8)}):
            pool = HostSamplerPool(plane, workers)
            try:
                pool.submit(*args).result()           # warm
                res = [pool.submit(*args).result() for _ in range(n)]
            finally:
                pool.close()
            for r in res:
                if tokens is None:
                    tokens = r.tokens
                assert np.array_equal(r.tokens, tokens), \
                    f"pool tokens differ at {workers} workers, B={B} V={V}"
            rec = {k: statistics.median(getattr(r, k) * 1e3 for r in res)
                   for k in ("transfer_time", "sampler_time")}
            rows[workers] = rec
            print(f"pool alone B={B} V={V} {workers} workers: median "
                  f"transfer {rec['transfer_time']:.3f} ms, sampler "
                  f"{rec['sampler_time']:.3f} ms over {n} submits [{card}]")
        out[f"B{B}_V{V}"] = rows
    return out


def pipeline_run(eng, reqs):
    """Serve ``reqs`` through a pipeline engine with the launch counters
    set to 0 just before and read just after; returns the serve report
    with the pipeline's numbers: ``pipeline_report()`` (Eq. 4's quantities
    for p separate cards), the run's cycles, the wall time of a cycle on
    this card (the run's seconds over its cycles) and the mean over full
    cycles of the stages' busy time plus the stall, the commits and the
    admissions of the run."""
    import statistics
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_batch
    admits = [0]
    admit = eng._admit_group

    def counted(i, reqs, admit=admit):
        admits[0] += 1
        return admit(i, reqs)

    eng._admit_group = counted
    eng.cycle_log.clear()
    c0, n0 = eng.planner.cycle, len(eng.stats_log)
    ops.reset_launch_counts()
    rep = serve_batch(eng, reqs)
    counts = ops.launch_counts()
    del eng._admit_group
    cycles = eng.planner.cycle - c0
    full = [r for r in eng.cycle_log if r.full]
    rep.update(pipeline=eng.pipeline_report(), cycles=cycles,
               wall_cycle_ms=rep["seconds"] / cycles * 1e3,
               busy_plus_stall_ms=statistics.mean(
                   sum(r.busy) + r.stall for r in full) * 1e3,
               commits=len(eng.stats_log) - n0, admissions=admits[0],
               launches={k: counts[k] for k in
                         ("penalty_scale", "shvs_masses", "fused_sample")})
    return rep


PIPELINE_SHAPES = ((2, 2), (2, 4), (4, 4), (4, 8))
# phase 7 runs smollm-360m at half its depth (16 of 32 layers, full
# width) to leave the script's time to phase 9
PIPELINE_LAYERS = 16
# a first difference of two greedy streams is allowed only where the top
# two logits lie within this of each other: bf16 GEMMs at R rows and at B
# rows may round differently (a few bf16 steps at logits of a few units)
GAP_CLEAR = 0.25


def serve_pipeline(dev, card):
    """Phase 7: the pipeline engine at full width through ``build_engine``
    (smollm-360m at ``PIPELINE_LAYERS`` = 16 of its 32 layers, bf16,
    batch 8, ``shvs``, contiguous): (p, M) in
    ``PIPELINE_SHAPES``, each with the decision in the host pool
    (``disaggregated``, 2 workers) and drawn synchronously on the card
    after the last stage (``baseline``); the paged cache at (2, 4) in both
    modes; and ``fused`` with k_cap = 2048 in ``baseline`` at (2, 4).
    Each engine serves 8 seeded requests of 16 new tokens (measured),
    then the same prompts greedy, which must equal the single-stage
    engine's greedy streams up to a first difference at a top-two gap
    below ``GAP_CLEAR``. Launches: every admission's prefill draw, and in
    ``baseline`` every commit's draw, launch the run's kernels."""
    from repro_torch.launch.serve import serve_batch, synth_requests
    V = V_MAIN
    eng = engine("shvs", dev, layers=PIPELINE_LAYERS)
    single = synth_requests(8, V, 16, greedy=True)
    serve_batch(eng, single)
    eng.close()
    configs = [(p, M, mode, "contiguous", "shvs", K_CAP)
               for p, M in PIPELINE_SHAPES
               for mode in ("baseline", "disaggregated")]
    configs += [(2, 4, mode, "paged", "shvs", K_CAP)
                for mode in ("baseline", "disaggregated")]
    configs += [(2, 4, "baseline", "contiguous", "fused", 2048)]
    out = {}
    for p, M, mode, cache, algorithm, k_cap in configs:
        name = f"{algorithm}_p{p}_M{M}_{mode}_{cache}"
        eng = engine(algorithm, dev, layers=PIPELINE_LAYERS, stages=p,
                     microbatches=M,
                     sampler_mode=mode, samplers=2, cache=cache, k_cap=k_cap)
        serve_batch(eng, synth_requests(2, V, 2, rng_seed=99, seed=0))  # warm
        reqs = synth_requests(8, V, 16, seed=0)
        rep = pipeline_run(eng, reqs)
        for r in reqs:
            assert r.finish_reason == "length" and len(r.output) == 16, \
                (name, r.request_id, r.finish_reason, len(r.output))
            assert all(0 <= t < V for t in r.output)
        greedy = synth_requests(8, V, 16, greedy=True)
        serve_batch(eng, greedy)
        eng.close()
        cmp = agreement(eng, greedy, single, dev)
        first = cmp["first_difference"]
        assert first is None or first["top2_gap"] < GAP_CLEAR, (name, cmp)
        rep["greedy_vs_single_stage"] = cmp
        # kernel launches: one draw an admission, plus one a commit in
        # baseline; the fused run launches fused_sample only
        want = rep["admissions"] + (rep["commits"] if mode == "baseline"
                                    else 0)
        got = rep["launches"]
        if algorithm == "fused":
            assert got["fused_sample"] == want > 0, (name, got, want)
        else:
            assert got["penalty_scale"] == got["shvs_masses"] == want > 0, \
                (name, got, want)
        out[name] = rep
        pr = rep["pipeline"]
        print(f"pipeline {name}: {rep['tok_per_s']:.1f} tok/s, TTFT p50 "
              f"{rep['ttft_p50_ms']:.2f} ms, TPOT p50 "
              f"{rep['tpot_p50_ms']:.2f} ms; {rep['cycles']} cycles, wall "
              f"{rep['wall_cycle_ms']:.2f} ms a cycle on this card (busy + "
              f"stall {rep['busy_plus_stall_ms']:.2f} ms a full cycle) vs "
              f"Eq. 4's C = mean_cycle_ms {pr['mean_cycle_ms']:.2f} ms on "
              f"{p} cards; bubble_frac {pr['bubble_frac']:.4f}, stage_util "
              f"{[round(u, 4) for u in pr['stage_util']]}, stall "
              f"{pr['stall_ms_mean']:.3f} ms, sync sample "
              f"{pr['sample_ms_mean']:.3f} ms, sampler "
              f"{pr['sampler_ms_mean']:.3f} ms, transfer "
              f"{pr['transfer_ms_mean']:.3f} ms over {pr['cycles']} full "
              f"cycles; launches {got} ({rep['admissions']} admissions, "
              f"{rep['commits']} commits); greedy vs single-stage agreement "
              f"{cmp['agreement']:.4f}, first difference {first} [{card}]")
    # the pool alone at the microbatches' R rows: its CPU time with no
    # stage dispatching beside it, against its sampler ms above
    out["pool_alone"] = pool_alone(
        dev, card, shapes=tuple((B_MAIN // M, V) for M in (2, 4, 8)))
    return out


def pipeline_only(dev, card):
    """``--pipeline-only``: phase 7 alone; prints one JSON line. Run it
    under different threading settings (``OMP_NUM_THREADS``), one process
    each."""
    import os
    import torch
    runs = serve_pipeline(dev, card)
    print(json.dumps({"pipeline_only": {
        "card": card, "env": {"OMP_NUM_THREADS":
                              os.environ.get("OMP_NUM_THREADS")},
        "torch_threads": torch.get_num_threads(), "runs": runs}}))
    return 0


# phase 8: KV migration, the prefill/decode handoff and the gateway
MIGRATE_POOL = dict(cache="paged", num_blocks=0)   # the memory-equal pool
HANDOFF_CONFIGS = (("shvs", "contiguous", 0), ("shvs", "paged", 0),
                   ("gumbel", "paged", 64))
GATEWAY_PROMPTS = ("the quick brown fox", "jumps over the lazy dog",
                   "sphinx of black quartz", "judge my vow",
                   "pack my box with", "five dozen liquor jugs",
                   "how vexingly quick", "daft zebras jump")


def migrate_payload(dev, card, cache):
    """Phase 8 (a): one request mid-decode exported from a full-width
    engine and imported into a second one over the same parameters. The
    exported K/V equal the source cache rows bit for bit, ``to_bytes`` ->
    ``from_bytes`` keeps the bf16 bits, and the importer's rows (K/V and
    histograms) are the payload's. Times: export with a synchronise (host
    clock) and the copy's device time (CUDA events), the bytes' round
    trip, the import's install (its ``kv_migrate`` span)."""
    import torch
    from repro_torch.engine import KVPayload
    from repro_torch.engine.paged_cache import gather_slot_kv
    from repro_torch.launch.serve import synth_requests, trace_telemetry
    kw = MIGRATE_POOL if cache == "paged" else {}
    a = engine("shvs", dev, telemetry=trace_telemetry("on"), **kw)
    b = engine("shvs", dev, params=a.params, telemetry=trace_telemetry("on"),
               **kw)
    bits = lambda t: t.contiguous().view(torch.int16)

    def rows(eng, slot, T):
        if cache == "paged":
            return gather_slot_kv(eng.cache, eng.alloc.owned[slot], T,
                                  eng.pcfg)
        return eng.cache["k"][:, slot, :T], eng.cache["v"][:, slot, :T]

    reqs = synth_requests(8, V_MAIN, 16, seed=0)
    a.submit(reqs)
    while len(reqs[3].output) < 4:
        a.step()
    a.flush()
    r = reqs[3]
    slot, T = r.slot, int(a.cache["len"][r.slot])
    src_k, src_v = (t.clone() for t in rows(a, slot, T))
    src_h = [t[slot].clone() for t in a.pstate]
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    p = a.export_request(r.request_id)
    e1.record()
    torch.cuda.synchronize()
    export_ms = (time.perf_counter() - t0) * 1e3
    assert p.k.dtype == torch.bfloat16 and p.kv_len == T
    assert torch.equal(bits(p.k), bits(src_k)) and \
        torch.equal(bits(p.v), bits(src_v)), "export changed K/V bits"
    assert torch.equal(p.prompt_counts, src_h[0]) and \
        torch.equal(p.output_counts, src_h[1])
    t0 = time.perf_counter()
    blob = p.to_bytes()
    t1 = time.perf_counter()
    q = KVPayload.from_bytes(blob)
    t2 = time.perf_counter()
    assert q.k.dtype == torch.bfloat16
    assert torch.equal(bits(q.k), bits(p.k).cpu()) and \
        torch.equal(bits(q.v), bits(p.v).cpu()), "bytes changed K/V bits"
    landed = b.import_request(q)
    b.step()                 # admission installs the payload, then decodes
    b.flush()
    got_k, got_v = rows(b, landed.slot, T)
    assert torch.equal(bits(got_k), bits(q.k).to(dev)) and \
        torch.equal(bits(got_v), bits(q.v).to(dev)), "import changed bits"
    assert torch.equal(b.pstate.prompt_counts[landed.slot].cpu(),
                       q.prompt_counts)
    want = q.output_counts.clone()
    for t in landed.output[len(q.output):]:
        want[t] += 1
    assert torch.equal(b.pstate.output_counts[landed.slot].cpu(), want)
    span = next(e for e in b.tracer.events() if e.kind == "kv_migrate")
    a.close()
    b.close()
    rep = {"cache": cache, "kv_len": T, "kv_bytes": p.nbytes,
           "bytes_per_token": p.nbytes // T, "npz_bytes": len(blob),
           "export_ms_synchronised": export_ms,
           "export_device_ms": e0.elapsed_time(e1),
           "to_bytes_ms": (t1 - t0) * 1e3, "from_bytes_ms": (t2 - t1) * 1e3,
           "import_install_ms": span.dur * 1e3}
    print(f"migration payload {cache}: T = {T} tokens, {p.nbytes} KV bytes "
          f"({p.nbytes // T} a token), npz {len(blob)} bytes; export "
          f"{export_ms:.3f} ms synchronised ({rep['export_device_ms']:.3f} "
          f"ms between events), to_bytes {rep['to_bytes_ms']:.1f} ms, "
          f"from_bytes {rep['from_bytes_ms']:.1f} ms, import install "
          f"{rep['import_install_ms']:.3f} ms (host); K/V and histograms "
          f"bitwise equal through export, bytes and import [{card}]")
    return rep


def migration_spans(engines):
    """Per-request export / import host ms, KV bytes and handoff wait ms
    from the engines' ``kv_migrate`` and ``handoff_wait`` spans."""
    ev = [e for eng in engines for e in eng.tracer.events()]
    pick = lambda kind, d=None: [e for e in ev if e.kind == kind and
                                 dict(e.args).get("direction") == d]
    med = lambda xs: sorted(xs)[len(xs) // 2] if xs else float("nan")
    out, inn = pick("kv_migrate", "out"), pick("kv_migrate", "in")
    wait = pick("handoff_wait")
    return {"migrations": len(out),
            "export_ms_p50": med([e.dur * 1e3 for e in out]),
            "import_ms_p50": med([e.dur * 1e3 for e in inn]),
            "handoff_wait_ms_p50": med([e.dur * 1e3 for e in wait]),
            "kv_bytes_p50": med([dict(e.args)["bytes"] for e in out]),
            "per_request": [
                {"request_id": dict(o.args)["request_id"],
                 "kv_len": dict(o.args)["kv_len"],
                 "bytes": dict(o.args)["bytes"],
                 "export_ms": o.dur * 1e3, "import_ms": i.dur * 1e3,
                 "handoff_wait_ms": w.dur * 1e3}
                for o, i, w in zip(*(sorted(x, key=lambda e: dict(
                    e.args)["request_id"]) for x in (out, inn, wait)))]}


def compare_streams(eng, got, want, dev):
    """Greedy/seeded streams that must be equal: the agreement and first
    difference (``agreement``), which is allowed only where the top-two
    logit gap is below ``GAP_CLEAR``; returns the comparison, counting the
    requests that differ."""
    cmp = agreement(eng, got, want, dev)
    first = cmp["first_difference"]
    assert first is None or first["top2_gap"] < GAP_CLEAR, cmp
    cmp["requests_differing"] = sum(a.output != b.output
                                    for a, b in zip(got, want))
    return cmp


# (kind, engine) of phase 8 (b)'s runs, in turns: the seeded batch on
# the never-migrated engine and through the handoff, then the greedy one
HANDOFF_TURNS = (("seeded", "single"), ("seeded", "handoff"),
                 ("seeded", "handoff"), ("seeded", "single"),
                 ("greedy", "single"), ("greedy", "handoff"))


def serve_handoff(dev, card):
    """Phase 8 (b): ``HandoffScheduler`` (one prefill engine, one decode
    engine over shared parameters) against one engine that never
    migrates: ``shvs`` contiguous, ``shvs`` paged, ``gumbel`` paged with
    chunked prefill (64) and long prompts, each on 8 requests of 16 new
    tokens, seeded-sampled (top_k 40, top_p 0.95: every row takes the
    per-request draw, so the streams do not depend on the schedule) and
    greedy, in the turns of ``HANDOFF_TURNS``. The prefill of all 8 rows
    and every decode step keep the single engine's GEMM shapes, so the
    streams are expected equal; a first difference is allowed only under
    the top-2 gap rule, and counted. Launch counters are set to 0 before
    each handoff run and read after it."""
    import torch
    from repro_torch.engine import HandoffScheduler
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import (latency_report, serve_batch,
                                          synth_requests, trace_telemetry)
    out, params = {}, None
    for algorithm, cache, chunk in HANDOFF_CONFIGS:
        kw = dict(prompt_chunk=chunk, **(MIGRATE_POOL if cache == "paged"
                                          else {}))
        single = engine(algorithm, dev, params=params, **kw)
        params = single.params
        hs = HandoffScheduler(*(engine(algorithm, dev, params=params,
                                       telemetry=trace_telemetry("on"), **kw)
                                for _ in range(2)))
        for warm in (single.generate, hs.generate):
            list(warm(synth_requests(2, V_MAIN, 2, rng_seed=99, seed=0)))
        for e in (hs.prefill, hs.decode):
            e.tracer.clear()
        name = f"{algorithm}_{cache}" + (f"_chunk{chunk}" if chunk else "")
        first = {}
        for turn, (kind, who) in enumerate(HANDOFF_TURNS):
            reqs = synth_requests(8, V_MAIN, 16, long_prompts=bool(chunk),
                                  **({"seed": 0} if kind == "seeded"
                                     else {"greedy": True}))
            if who == "single":
                rep = serve_batch(single, reqs)
                if kind in first:        # the same engine, the same bits
                    assert [r.output for r in reqs] == \
                        [r.output for r in first[kind]], (name, kind)
                first.setdefault(kind, reqs)
            else:
                n0 = hs.migrated
                t0 = time.perf_counter()
                for r in reqs:
                    r.arrival_time = t0
                ops.reset_launch_counts()
                list(hs.generate(reqs))
                torch.cuda.synchronize(dev)
                counts = ops.launch_counts()
                rep = latency_report(reqs, t0, time.perf_counter())
                assert hs.migrated - n0 == 8
                assert all(r.handoff_count == 1 for r in reqs)
                want = ("gumbel_argmax" if algorithm == "gumbel"
                        else "shvs_masses")
                assert counts["penalty_scale"] > 0 and counts[want] > 0, \
                    counts
                cmp = compare_streams(single, reqs, first[kind], dev)
                spans = migration_spans((hs.prefill, hs.decode))
                for e in (hs.prefill, hs.decode):
                    e.tracer.clear()
                rep.update(launches=counts, vs_never_migrated=cmp,
                           spans=spans)
            for r in reqs:
                assert r.finish_reason == "length" and len(r.output) == 16, \
                    (name, kind, who, r.request_id, r.finish_reason)
            out[f"{name}_{kind}_{who}_turn{turn}"] = rep
            line = (f"handoff {name} turn {turn} {kind} {who}: "
                    f"{rep['tok_per_s']:.1f} tok/s, TTFT p50 "
                    f"{rep['ttft_p50_ms']:.2f} ms, TPOT p50 "
                    f"{rep['tpot_p50_ms']:.2f} ms")
            if who == "handoff":
                per = [(q["request_id"], q["kv_len"]) + tuple(
                    round(q[k], 3) for k in
                    ("export_ms", "import_ms", "handoff_wait_ms"))
                    for q in spans["per_request"]]
                line += (f"; {spans['migrations']} migrations, per request "
                         f"p50: export {spans['export_ms_p50']:.3f} ms, "
                         f"import {spans['import_ms_p50']:.3f} ms (host), "
                         f"{spans['kv_bytes_p50']} KV bytes, handoff wait "
                         f"{spans['handoff_wait_ms_p50']:.3f} ms; per "
                         f"request (id, tokens, export ms, import ms, wait "
                         f"ms): {per}; launches "
                         f"{counts}; vs never migrated: agreement "
                         f"{cmp['agreement']:.4f}, "
                         f"{cmp['requests_differing']} requests differ, "
                         f"first difference {cmp['first_difference']}")
            print(f"{line} [{card}]")
        hs.close()
        single.close()
    return out, params


def gateway_run(fleet, prompts, payloads, warm=2):
    """Serve ``payloads`` concurrently over live HTTP/SSE from ``fleet``
    (after ``warm`` short requests, one at a time); returns the results,
    the wire summary of the measured requests and each replica's stats."""
    import asyncio
    from repro_torch.gateway import GatewayServer, summarize_traces
    from repro_torch.gateway.client import stream_completion

    async def drive():
        gw = GatewayServer(fleet)
        await gw.serve(host="127.0.0.1", port=0)
        try:
            for i in range(warm):
                res = await stream_completion(gw.host, gw.port, {
                    "prompt": prompts[i], "max_tokens": 2, "seed": 1})
                assert res.status == 200 and res.error is None, res.error
            n0 = len(gw.traces)
            results = await asyncio.gather(*[
                stream_completion(gw.host, gw.port, pl) for pl in payloads])
            wire = summarize_traces(list(gw.traces)[n0:])
            stats = {r.name: r.stats() for r in fleet.replicas}
        finally:
            await gw.shutdown()
        return results, wire, stats

    return asyncio.run(drive())


def serve_gateway(dev, card, params):
    """Phase 8 (c): ``GatewayServer`` on 127.0.0.1:0 with 8 concurrent
    ``stream_completion`` clients (4 seeded-sampled, 4 greedy; 16 tokens
    each) over 1 replica, 2 replicas and a disaggregated fleet of 1
    prefill + 1 decode paged replica, all full-width smollm-360m over ONE
    parameter tree on this card, each replica driven from its fleet
    worker thread. Wire streams must equal one engine's in-process
    streams of the same requests (a first difference only under the top-2
    gap rule, counted). Prints wire TTFT and TPOT p50, each replica's
    stats with its ``migration_stats()``, and the decision kernels'
    launches in the measured run."""
    from repro_torch.engine import Request
    from repro_torch.gateway import ByteCodec, ReplicaFleet
    from repro_torch.config import SamplingConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_batch
    codec = ByteCodec()

    def contract(i):
        return (dict(temperature=0.9, top_k=40, top_p=0.95,
                     repetition_penalty=1.1, seed=7000 + i) if i % 2 == 0
                else dict(greedy=True, repetition_penalty=1.1))

    payloads = [{"prompt": p, "max_tokens": 16, "session_id": f"s{i}",
                 **contract(i)} for i, p in enumerate(GATEWAY_PROMPTS)]
    inproc = engine("shvs", dev, params=params)
    serve_batch(inproc, [Request(request_id=99, prompt=codec.encode("warm"),
                                 max_new_tokens=2)])
    want = [Request(request_id=i, prompt=codec.encode(p), max_new_tokens=16,
                    sampling=SamplingConfig(**contract(i)))
            for i, p in enumerate(GATEWAY_PROMPTS)]
    ref_rep = serve_batch(inproc, want)
    print(f"gateway reference (one engine in process): "
          f"{ref_rep['tok_per_s']:.1f} tok/s, TTFT p50 "
          f"{ref_rep['ttft_p50_ms']:.2f} ms, TPOT p50 "
          f"{ref_rep['tpot_p50_ms']:.2f} ms [{card}]")
    out = {"in_process": ref_rep}
    fleets = (("1_replica", 1, None, {}),
              ("2_replicas", 2, None, {}),
              ("disaggregated_1p1d", 2, ["prefill", "decode"], MIGRATE_POOL))
    for name, n, roles, kw in fleets:
        engines = [engine("shvs", dev, params=params, **kw)
                   for _ in range(n)]
        fleet = ReplicaFleet(engines, capacity=16, roles=roles)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        results, wire, stats = gateway_run(fleet, GATEWAY_PROMPTS, payloads)
        seconds = time.perf_counter() - t0
        counts = ops.launch_counts()
        assert all(e._closed for e in engines)
        got = []
        for i, res in enumerate(results):
            assert res.status == 200 and res.error is None, (name, res.error)
            assert res.finish_reason == "length" and len(res.tokens) == 16
            r = Request(request_id=i, prompt=want[i].prompt,
                        max_new_tokens=16)
            r.output = list(res.tokens)
            got.append(r)
        cmp = compare_streams(inproc, got, want, dev)
        assert counts["penalty_scale"] > 0 and counts["shvs_masses"] > 0
        if roles:
            moved = sum(s["migrations_out"] for s in stats.values())
            assert moved == sum(s["migrations_in"] for s in stats.values())
            assert moved >= len(payloads), stats
        if n == 2 and not roles:
            assert all(s["served"] > 0 for s in stats.values()), stats
        out[name] = {"wire": wire, "replicas": stats, "launches": counts,
                     "seconds_with_warmup": seconds, "vs_in_process": cmp}
        print(f"gateway {name}: wire TTFT p50 {wire['ttft_ms']['p50']:.2f} "
              f"ms, TPOT p50 {wire['tpot_ms']['p50']:.2f} ms, queue p50 "
              f"{wire['queue_ms']['p50']:.2f} ms over {wire['finished']} "
              f"streams; replicas {stats}; launches {counts}; wire vs in "
              f"process: agreement {cmp['agreement']:.4f}, "
              f"{cmp['requests_differing']} requests differ, first "
              f"difference {cmp['first_difference']} [{card}]")
    inproc.close()
    return out


def serve_migration(dev, card):
    """Phase 8: the payload (a), the handoff (b) and the gateway (c)."""
    out = {"payload": [migrate_payload(dev, card, cache)
                       for cache in ("contiguous", "paged")]}
    out["handoff"], params = serve_handoff(dev, card)
    out["gateway"] = serve_gateway(dev, card, params)
    return out


def migration_only(dev, card):
    """``--migration-only``: phase 8 alone; prints one JSON line."""
    print(json.dumps({"migration_only": {
        "card": card, "switch_interval_s": sys.getswitchinterval(),
        "runs": serve_migration(dev, card)}}))
    return 0


# phase 9: the MoE, RWKV-6 and Zamba2 families at full width
FAMILIES = {"granite-moe-1b-a400m": (24, 1024, 49155),   # (L, d, V)
            "rwkv6-3b": (32, 2560, 65536),
            "zamba2-1.2b": (38, 2048, 32000)}
FAMILY_NEW = 16


def family_engine(arch, algorithm, dev, params, **kw):
    """``build_engine`` over one family's parameter tree: batch 8,
    max_seq 256, H = min(1024, V/4), k_cap 256; ``arch`` an arch id or a
    ``ModelConfig``."""
    from repro_torch.launch.serve import build_engine
    eng = build_engine(arch, False, algorithm, B_MAIN, 256, device=dev,
                       params=params, **kw)
    V = eng.cfg.vocab_size
    assert eng.ecfg.shvs.resolve_hot_size(V) == min(1024, V // 4) and \
        eng.decision.k_cap == kw.get("k_cap", K_CAP)
    return eng


def family_serve(eng, reqs, name, card):
    """Serve ``reqs`` with the launch counters set to 0 just before and
    read just after; every request must finish with its length."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_batch
    V = eng.cfg.vocab_size
    ops.reset_launch_counts()
    rep = serve_batch(eng, reqs)
    rep["launches"] = ops.launch_counts()
    for r in reqs:
        assert r.finish_reason == "length" and \
            len(r.output) == r.max_new_tokens, \
            (name, r.request_id, r.finish_reason, len(r.output))
        assert all(0 <= t < V for t in r.output)
    print(f"{name}: {rep['requests']} requests, {rep['tokens']} tokens, "
          f"{rep['tok_per_s']:.1f} tok/s, TTFT p50 {rep['ttft_p50_ms']:.2f} "
          f"ms, TPOT p50 {rep['tpot_p50_ms']:.2f} ms, launches "
          f"{rep['launches']} [{card}]")
    return rep


def gap_checked(eng, a, b, dev, name, assert_gap=True):
    """``agreement`` of two greedy runs; with ``assert_gap`` a first
    difference must lie where the top-two logit gap is below
    ``GAP_CLEAR``."""
    cmp = agreement(eng, a, b, dev)
    first = cmp["first_difference"]
    if assert_gap:
        assert first is None or first["top2_gap"] < GAP_CLEAR, (name, cmp)
    return cmp


def no_sync_steps(eng, reqs, n=3):
    """``n`` steady-state steps of ``eng`` under sync debug mode "error":
    any synchronising call raises."""
    import torch
    eng.submit(reqs)
    eng.step()                  # admission reads the first tokens back
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(n):
            eng.step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    eng.flush()


def weight_floor(cfg, params):
    """The device's floor a decode step from weight bytes over the HBM
    rate: every parameter read once (at batch 8 the (E, C, d) dispatch
    reads every expert), Zamba2's shared block once a site."""
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    if cfg.family == "hybrid":
        sites = -(-cfg.num_layers // cfg.hybrid.attn_every)
        shared = sum(t.numel() * t.element_size() for k in
                     ("shared_attn", "shared_mlp")
                     for t in _leaves(params["stack"][k]))
        nbytes += (sites - 1) * shared
    return nbytes, nbytes / HBM_BYTES_PER_S * 1e3


def family_consistency(model, params, dev, card, extra=None):
    """Phase 9 (b): prefill(T-3) + 3 teacher-forced decode steps against
    prefill(T), unpadded, through ``Model`` (batch 2, T = 24), in bf16 and
    with the weights widened to f32: the max relative error of the
    logits (asserted below 1e-3 in f32, the state carry's check; in bf16
    seeded random weights amplify rounding with depth), and equal argmax
    where the top-two gap is clear. MoE runs at capacity_factor = E, as
    the reference's own consistency test does (its reduced configs never
    drop): drops depend on the tokens of the call."""
    import dataclasses
    import torch
    from repro_torch.models.model import Model
    cfg = model.cfg
    if cfg.moe is not None:
        cfg = with_capacity(cfg, float(cfg.moe.num_experts))
    B, T = 2, 24
    toks = torch.randint(1, cfg.vocab_size, (B, T), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(11)).to(dev)
    out = {}
    for dtype in ("bfloat16", "float32"):
        m = Model(dataclasses.replace(cfg, dtype=dtype))
        p = params if dtype == "bfloat16" else _cast(params, torch.float32)
        full, _ = m.prefill(p, {"tokens": toks, **(extra or {})},
                            m.init_cache(B, 256, device=dev))
        logits, cache = m.prefill(p, {"tokens": toks[:, :T - 3],
                                      **(extra or {})},
                                  m.init_cache(B, 256, device=dev))
        for t in range(T - 3, T):
            logits, cache = m.decode_step(p, toks[:, t], cache)
        del p, cache
        assert torch.isfinite(logits).all() and logits.shape == full.shape
        rel = ((logits - full).abs().max() / full.abs().max()).item()
        top = full.topk(2, dim=-1).values
        clear = (top[:, 0] - top[:, 1]) >= GAP_CLEAR
        same = logits.argmax(-1) == full.argmax(-1)
        assert bool((same | ~clear).all()), (cfg.name, dtype, rel)
        if dtype == "float32":
            assert rel < 1e-3, (cfg.name, rel)
        out[dtype] = {"max_rel_err": rel, "argmax_equal": int(same.sum()),
                      "clear_rows": int(clear.sum())}
        print(f"{cfg.name} consistency ({dtype}, prefill {T - 3} + 3 decode "
              f"vs prefill {T}): max rel err of the logits {rel:.3g}, argmax "
              f"equal on {int(same.sum())}/{B} rows ({int(clear.sum())} with "
              f"a clear gap) [{card}]")
    torch.cuda.empty_cache()
    return out


def _cast(tree, dtype):
    return {k: _cast(v, dtype) if isinstance(v, dict) else v.to(dtype)
            for k, v in tree.items()}


def prefill_ms(model, params, dev, Sp=32):
    """Median ms of ``Model.prefill`` at B = 8, Sp tokens (host clock
    around a synchronise, 3 runs after one warm-up)."""
    import statistics
    import torch
    toks = torch.randint(1, model.cfg.vocab_size, (B_MAIN, Sp),
                         dtype=torch.int32, device=dev)
    times = []
    for i in range(4):
        cache = model.init_cache(B_MAIN, 256, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(params, {"tokens": toks}, cache)
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def serve_family(arch, dev, card):
    """Phase 9 (a), (b), (e), (f) for one family, and (c), (d) for the MoE
    family; returns the records and the launches of the main runs."""
    import torch
    from repro_torch.config import get_arch
    from repro_torch.launch.serve import serve_batch, synth_requests
    from repro_torch.models.model import Model
    cfg = get_arch(arch)
    L, d, V = FAMILIES[arch]
    assert (cfg.num_layers, cfg.d_model, cfg.vocab_size, cfg.dtype) == \
        (L, d, V, "bfloat16"), arch
    model = Model(cfg)
    params = model.init(seed=0, device=dev)
    n_params = sum(t.numel() for t in _leaves(params))
    wbytes, floor_ms = weight_floor(cfg, params)
    print(f"{arch} full width: {n_params} parameters, {wbytes} weight bytes "
          f"a decode step, floor {floor_ms:.3f} ms at 3.35 TB/s")
    out = {"parameters": n_params, "weight_bytes": wbytes,
           "weight_floor_ms": floor_ms}
    secs, t0 = {}, time.perf_counter()

    def lap(part):
        nonlocal t0
        now = time.perf_counter()
        secs[part] = now - t0
        t0 = now

    seeded = lambda: synth_requests(8, V, FAMILY_NEW, seed=0)
    greedy = lambda: synth_requests(8, V, FAMILY_NEW, greedy=True)
    # (a) shvs and fused: two runs, overlapped and sequential, no sync
    streams, counts, greedy_runs = {}, {}, {}
    for algorithm in ("shvs", "fused"):
        eng = family_engine(arch, algorithm, dev, params)
        serve_batch(eng, synth_requests(2, V, 2, rng_seed=99, seed=0))
        runs = []
        for run in range(2):
            reqs = seeded()
            rep = family_serve(eng, reqs, f"{arch} {algorithm} run {run}",
                               card)
            runs.append([r.output for r in reqs])
            out[f"{algorithm}_run{run}"] = rep
        counts[algorithm] = out[f"{algorithm}_run0"]["launches"]
        assert runs[0] == runs[1], (arch, algorithm, "two runs differ")
        g = greedy()
        serve_batch(eng, g)
        greedy_runs[algorithm] = g
        if algorithm == "shvs":
            no_sync_steps(eng, seeded())
        eng.close()
        eng = family_engine(arch, algorithm, dev, params, overlap=False)
        reqs = seeded()
        out[f"{algorithm}_sequential"] = family_serve(
            eng, reqs, f"{arch} {algorithm} sequential", card)
        eng.close()
        assert [r.output for r in reqs] == runs[0], \
            (arch, algorithm, "sequential differs from overlapped")
        streams[algorithm] = runs[0]
    assert counts["shvs"]["penalty_scale"] > 0 and \
        counts["shvs"]["shvs_masses"] > 0 and \
        counts["fused"]["fused_sample"] > 0, (arch, counts)
    eng = family_engine(arch, "reference", dev, params)
    greedy_runs["reference"] = greedy()
    serve_batch(eng, greedy_runs["reference"])
    out["greedy"] = {f"{a}_vs_reference": gap_checked(
        eng, greedy_runs[a], greedy_runs["reference"], dev, arch)
        for a in ("shvs", "fused")}
    eng.close()
    print(f"{arch}: two runs equal, overlapped ≡ sequential (shvs, fused), "
          f"3 steady-state steps made no synchronising call; greedy vs "
          f"reference {out['greedy']} [{card}]")
    lap("a")
    # (b) the prefill/decode consistency of the reference's tests
    out["consistency"] = family_consistency(model, params, dev, card)
    lap("b")
    if cfg.family == "moe":
        out["paged"] = family_paged(arch, dev, params, card)
        lap("c")
        out["pipeline"] = family_pipeline(arch, dev, params, card)
        lap("d")
    else:
        # (e) the gates: no paged cache; chunking ignored
        try:
            family_engine(arch, "shvs", dev, params, cache="paged")
        except AssertionError as e:
            out["paged_refused"] = str(e)
        else:
            raise AssertionError(f"{arch}: cache='paged' was accepted")
        eng = family_engine(arch, "shvs", dev, params, prompt_chunk=64)
        assert eng.scheduler.prompt_chunk == 0
        reqs = seeded()
        out["chunk_ignored"] = family_serve(
            eng, reqs, f"{arch} shvs prompt_chunk=64", card)
        eng.close()
        assert [r.output for r in reqs] == streams["shvs"], \
            f"{arch}: prompt_chunk changed the streams"
        print(f"{arch}: cache='paged' refused ({out['paged_refused']}); "
              f"prompt_chunk=64 served monolithically, streams equal")
        lap("e")
    # (f) the step profile and the prefill
    eng = family_engine(arch, "shvs", dev, params)
    rec, _ = step_profile(eng, synth_requests(8, V, 64, seed=0))
    eng.close()
    rec["launches_per_layer"] = rec["launches_per_step"] / L
    rec["prefill_ms_sp32"] = prefill_ms(model, params, dev)
    rec["weight_floor_ms"] = floor_ms
    out["step_profile"] = rec
    lap("f")
    out["seconds"] = secs
    print(f"{arch} step profile (shvs): wall {rec['wall_ms_per_step']:.2f} "
          f"ms/step, device busy {rec['device_busy_ms_per_step']:.2f} ms/step "
          f"(idle share {rec['idle_share']:.1%}; weight floor "
          f"{floor_ms:.3f} ms), {rec['launches_per_step']:.0f} launches/step "
          f"({rec['launches_per_layer']:.1f} a layer), decision kernels "
          f"{rec['decision_kernels_ms_per_step']}; prefill B=8 Sp=32 "
          f"{rec['prefill_ms_sp32']:.1f} ms [{card}]")
    print(f"{arch} phase 9 parts took (s): "
          f"{ {k: round(v, 1) for k, v in secs.items()} }")
    del params, model
    torch.cuda.empty_cache()
    return out, counts


def family_paged(arch, dev, params, card):
    """Phase 9 (c): the MoE family on the paged cache (blocks of 16, a pool
    of 16 blocks: decode growth preempts) with chunked prefill (64),
    ``gumbel``, the long prompts of phase 4's second path: the decision
    kernels serve V = 49155; two runs equal; greedy paged vs contiguous
    agreement printed (chunks and preemption change the calls' tokens, so
    capacity drops and bf16 GEMM shapes differ)."""
    from repro_torch.launch.serve import serve_batch, synth_requests
    V = FAMILIES[arch][2]
    out, streams = {}, []
    for run in range(2):
        eng = family_engine(arch, "gumbel", dev, params, **PAGED)
        serve_batch(eng, synth_requests(2, V, 2, rng_seed=99, seed=0))
        p0 = eng.scheduler.preemptions
        reqs = paged_requests(V)
        rep = family_serve(eng, reqs, f"{arch} gumbel paged run {run}",
                           card)
        rep["preemptions"] = eng.scheduler.preemptions - p0
        eng.close()
        assert rep["preemptions"] > 0, "the pool was meant to exhaust"
        assert rep["launches"]["gumbel_argmax"] > 0 and \
            rep["launches"]["penalty_scale"] > 0, rep["launches"]
        assert eng.alloc.num_free == eng.pcfg.num_blocks
        streams.append([r.output for r in reqs])
        out[f"gumbel_paged_run{run}"] = rep
    assert streams[0] == streams[1], f"{arch} paged: two runs differ"
    greedy = {}
    for name, kw in (("contiguous", {}), ("paged_chunked", PAGED)):
        eng = family_engine(arch, "reference", dev, params, **kw)
        greedy[name] = paged_requests(V, greedy=True, max_new=FAMILY_NEW)
        with counted_drops(eng) as drops:
            serve_batch(eng, greedy[name])
        out[f"greedy_{name}_drops"] = dict(drops)
        eng.close()
    cmp = gap_checked(eng, greedy["paged_chunked"], greedy["contiguous"],
                      dev, arch, assert_gap=False)
    out["greedy_paged_vs_contiguous"] = cmp
    print(f"{arch} paged: two runs equal "
          f"({out['gumbel_paged_run0']['preemptions']} preemptions a run);"
          f" greedy paged+chunked vs contiguous: token agreement "
          f"{cmp['agreement']:.4f}, first difference "
          f"{cmp['first_difference']}; (token, k) pairs dropped "
          f"{out['greedy_contiguous_drops']} contiguous, "
          f"{out['greedy_paged_chunked_drops']} paged+chunked [{card}]")
    return out


def family_pipeline(arch, dev, params, card):
    """Phase 9 (d): the MoE family through ``PipelineEngine`` at (p, M) =
    (2, 4), ``baseline`` and ``disaggregated``, against the single-stage
    engine's greedy streams. A pipeline admits a microbatch's R = 2 rows
    a prefill where the single-stage engine admits 8, so at the config's
    capacity factor the prefills drop other pairs: there (``baseline``
    only) the agreement and the drops are printed. At capacity_factor = E
    nothing drops, and the streams must agree under the gap rule."""
    from repro_torch.config import get_arch
    from repro_torch.launch.serve import serve_batch, synth_requests
    cfg = get_arch(arch)
    V = cfg.vocab_size
    out = {}
    for label, c in (("config", cfg),
                     ("no_drops", with_capacity(
                         cfg, float(cfg.moe.num_experts)))):
        eng = family_engine(c, "shvs", dev, params)
        single = synth_requests(8, V, FAMILY_NEW, greedy=True)
        with counted_drops(eng) as drops:
            serve_batch(eng, single)
        eng.close()
        out[f"single_{label}_drops"] = dict(drops)
        modes = ("baseline", "disaggregated") if label == "no_drops" \
            else ("baseline",)
        for mode in modes:
            name = f"{label}_p2_M4_{mode}"
            eng = family_engine(c, "shvs", dev, params, stages=2,
                                microbatches=4, sampler_mode=mode,
                                samplers=2)
            serve_batch(eng, synth_requests(2, V, 2, rng_seed=99, seed=0))
            rep = pipeline_run(eng, synth_requests(8, V, FAMILY_NEW, seed=0))
            g = synth_requests(8, V, FAMILY_NEW, greedy=True)
            with counted_drops() as drops:
                serve_batch(eng, g)
            eng.close()
            rep["greedy_drops"] = dict(drops)
            rep["greedy_vs_single_stage"] = cmp = gap_checked(
                eng, g, single, dev, name, assert_gap=label == "no_drops")
            assert rep["launches"]["penalty_scale"] > 0, rep["launches"]
            out[name] = rep
            print(f"{arch} pipeline {name}: {rep['tok_per_s']:.1f} tok/s, "
                  f"TPOT p50 {rep['tpot_p50_ms']:.2f} ms, wall "
                  f"{rep['wall_cycle_ms']:.2f} ms a cycle, launches "
                  f"{rep['launches']}; greedy vs single-stage agreement "
                  f"{cmp['agreement']:.4f}, first difference "
                  f"{cmp['first_difference']}; pairs dropped "
                  f"{rep['greedy_drops']} (single-stage "
                  f"{out[f'single_{label}_drops']}) [{card}]")
    return out


def serve_families(dev, card):
    """Phase 9: the three families at full width, one at a time."""
    out, counts = {}, {}
    for arch in FAMILIES:
        out[arch], counts[arch] = serve_family(arch, dev, card)
    return out, counts


def families_only(dev, card):
    """``--families-only``: phases 3 and 9; prints one JSON line."""
    model = check_model(dev)
    runs, counts = serve_families(dev, card)
    print(json.dumps({"families_only": {
        "card": card, "model_check_max_abs_err": model, "runs": runs,
        "launches": counts}}))
    return 0


# phase 10: the training path, and the VLM and audio inputs, at full width
TRAIN_STEPS, TRAIN_B, TRAIN_S = 25, 8, 128
LONG_TRAIN_S, LONG_PREFILL_S = 4096, 4608   # 4608: no multiple of 512
REMAT_GRAD_TOL = 5e-2   # bf16 gradients; the embedding's backward adds
#                         with atomics, so its sums may round differently
CHUNK_REL_TOL = 1e-4    # f32 logits, blocked vs direct softmax sums
# (L, d, V) of the phase's archs, checked against their configs
TRAIN_ARCHS = {"smollm-360m": (32, 960, 49152),
               "internvl2-2b": (24, 2048, 92553),
               "whisper-base": (6, 512, 51865)}
PATCHES, FRAMES = 256, 1500


def full_arch(name):
    """The registered full-width config of ``name``, bf16, its widths
    checked."""
    from repro_torch.config import get_arch
    cfg = get_arch(name)
    assert (cfg.num_layers, cfg.d_model, cfg.vocab_size, cfg.dtype) == \
        TRAIN_ARCHS[name] + ("bfloat16",), name
    return cfg


def train_config():
    """The reference's ``TrainConfig`` (remat on, clip 1.0, z-loss 1e-4,
    decay 0.1) with a short warmup and a larger rate, so 25 steps move
    the loss."""
    from repro_torch.config import TrainConfig
    return TrainConfig(learning_rate=1e-3, warmup_steps=5)


def gib():
    """Peak device memory since the last :func:`reset_peak`, GiB."""
    import torch
    return torch.cuda.max_memory_allocated() / 2**30


def reset_peak():
    """Synchronise, reset the peak, and return the GiB allocated now (what
    earlier phases still hold, counted in every later peak)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated() / 2**30


@contextlib.contextmanager
def swapped(module, name, value):
    """``module.name`` set to ``value`` inside the block."""
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def counted(module, name):
    """``swapped`` with a wrapper that counts the calls in ``calls[0]``."""
    fn, calls = getattr(module, name), [0]

    def wrapper(*a, **kw):
        calls[0] += 1
        return fn(*a, **kw)
    return swapped(module, name, wrapper), calls


def to_dev(batch, dev):
    import torch
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def leaves_equal(a, b):
    """Every leaf of two trees (or ``AdamWState``s) equal bit for bit."""
    import torch
    from repro_torch.training.optimizer import tree_leaves
    if isinstance(a, tuple):
        return all(leaves_equal(x, y) for x, y in zip(a, b))
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x.view(torch.int16), y.view(
            torch.int16)) if x.dtype == torch.bfloat16 else torch.equal(x, y)
        for x, y in zip(la, lb))


def train_step_once(model, params, batch, dev, card, name):
    """One ``make_train_step`` step (AdamW from fresh moments) on a batch
    of device tensors: its ms (host clock around a synchronise), peak
    memory and loss; the loss and gradient norm must be finite."""
    import math
    import torch
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.train_loop import make_train_step
    step = make_train_step(model, train_config())
    opt = adamw_init(params)
    base = reset_peak()
    t0 = time.perf_counter()
    new, opt, m = step(params, opt, batch)
    loss, gnorm = float(m["loss"]), float(m["grad_norm"])
    torch.cuda.synchronize()
    rec = {"ms": (time.perf_counter() - t0) * 1e3, "peak_gib": gib(),
           "allocated_before_gib": base, "loss": loss, "grad_norm": gnorm,
           "shape": {k: list(v.shape) for k, v in batch.items()}}
    del new, opt
    assert math.isfinite(loss) and math.isfinite(gnorm) and gnorm > 0, \
        (name, rec)
    print(f"{name} train step {rec['shape']}: {rec['ms']:.1f} ms, peak "
          f"{rec['peak_gib']:.2f} GiB ({base:.2f} GiB allocated before), "
          f"loss {loss:.4f}, grad norm {gnorm:.4f} [{card}]")
    return rec


def plane_decode(model, params, batch, dev, card, name, seq, new=16):
    """``Model.prefill`` of ``batch`` (B rows, its patches or frames
    included) then ``new`` decode steps whose tokens ``DecisionPlane.step``
    draws (``shvs``, H = 1024, k_cap 256, seeded top-k/top-p rows with a
    repetition penalty), the launch counters set to 0 just before and read
    just after: the decision kernels launch every step."""
    import torch
    from repro_torch.config import SamplingConfig, SHVSConfig
    from repro_torch.core.decision_plane import DecisionPlane
    from repro_torch.engine.engine import SlotParams
    from repro_torch.kernels import ops
    V = model.cfg.vocab_size
    B = batch["tokens"].shape[0]
    plane = DecisionPlane(V, algorithm="shvs",
                          shvs=SHVSConfig(hot_size=H_MAIN), k_cap=K_CAP,
                          seed=0, device=dev)
    sp = SlotParams(B, V, dev)
    for b in range(B):
        sp.set_row(b, SamplingConfig(temperature=0.8, top_k=40, top_p=0.95,
                                     repetition_penalty=1.1, seed=b))
    state = plane.init_state(B)
    cache = model.init_cache(B, seq, device=dev)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch, cache)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    drawn = []
    for s in range(new):
        tokens, state, _ = plane.step(logits, state, sp.as_params(), s)
        drawn.append(tokens)
        logits, cache = model.decode_step(params, tokens, cache)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = ops.launch_counts()
    out = torch.stack(drawn, 1)
    assert bool(((out >= 0) & (out < V)).all()), name
    assert bool(torch.isfinite(logits).all()), name
    assert counts["penalty_scale"] >= new and counts["shvs_masses"] >= new, \
        (name, counts)
    rec = {"prefill_ms": (t1 - t0) * 1e3,
           "decode_ms_per_step": (t2 - t1) / new * 1e3,
           "len": cache["len"].tolist(), "launches": counts,
           "tokens_row0": out[0].tolist()}
    print(f"{name}: prefill {rec['prefill_ms']:.1f} ms, {new} decode steps "
          f"drawn through DecisionPlane.step {rec['decode_ms_per_step']:.2f} "
          f"ms each, lengths {rec['len']}, launches {counts} [{card}]")
    return rec


def train_smollm(dev, card):
    """Phase 10 (a): full-width smollm-360m trained for 25 steps from its
    seeded init; returns the record and the trainer."""
    import math
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.model import Model
    from repro_torch.training import Trainer
    from repro_torch.training.checkpoint import (restore_checkpoint,
                                                 save_checkpoint)
    from repro_torch.training.data import DataConfig, SyntheticDataset
    from repro_torch.training.optimizer import adamw_init, tree_leaves
    from repro_torch.training.train_loop import grads_of
    from repro_torch.launch.serve import synth_requests
    cfg = full_arch("smollm-360m")
    V = cfg.vocab_size
    tc = train_config()
    tr = Trainer(cfg, tc, seed=0, device=dev)
    ds = SyntheticDataset(DataConfig(vocab_size=V, seq_len=TRAIN_S,
                                     batch_size=TRAIN_B, seed=0))
    batches = [ds.sample_batch() for _ in range(TRAIN_STEPS + 1)]
    out = {"parameters": sum(t.numel() for t in tree_leaves(tr.params))}
    # remat off and on, the first batch, before any step
    b0 = to_dev(batches[0], dev)
    la, _, ga = grads_of(tr.model, tr.params, b0, tc, remat=False)
    lb, _, gb = grads_of(tr.model, tr.params, b0, tc, remat=True)
    worst = max(((x.float() - y.float()).abs().max() /
                 x.float().abs().max().clamp(min=1e-30)).item()
                for x, y in zip(tree_leaves(ga), tree_leaves(gb)))
    del ga, gb
    out["remat"] = {"loss_off": float(la), "loss_on": float(lb),
                    "max_rel_grad_diff": worst}
    assert float(la) == float(lb) and worst <= REMAT_GRAD_TOL, out["remat"]
    print(f"smollm-360m remat: loss {float(la):.6f} off, {float(lb):.6f} on; "
          f"max leaf-relative gradient difference {worst:.3g} (tolerance "
          f"{REMAT_GRAD_TOL}) [{card}]")
    # 25 logged steps: each step's metrics read back, so the cumulative
    # elapsed time of the history steps between synchronisations
    out["allocated_before_gib"] = reset_peak()
    hist = tr.fit(iter(batches[:TRAIN_STEPS]), steps=TRAIN_STEPS,
                  log_every=1, log_fn=None)
    out["peak_gib"] = gib()
    prev, steps = 0.0, []
    for h in hist:
        ms = (h["elapsed_s"] - prev) * 1e3
        prev = h["elapsed_s"]
        steps.append({"step": h["step"], "loss": h["loss"],
                      "grad_norm": h["grad_norm"], "lr": h["lr"], "ms": ms,
                      "tokens_per_s": TRAIN_B * TRAIN_S / ms * 1e3})
        print(f"train step {h['step']}: loss {h['loss']:.4f}, grad norm "
              f"{h['grad_norm']:.4f}, {ms:.1f} ms, "
              f"{steps[-1]['tokens_per_s']:.0f} tokens/s [{card}]")
    out["steps"] = steps
    losses = [h["loss"] for h in hist]
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], losses
    # one more step under the profiler: launches and device time
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tr.fit(iter(batches[TRAIN_STEPS:]), steps=1, log_every=1,
               log_fn=None)
        torch.cuda.synchronize()
    busy, launches, _ = profile_totals(prof, 1)
    steady = sorted(x["ms"] for x in steps[1:])[len(steps[1:]) // 2]
    out["profile"] = {"launches_per_step": launches,
                      "device_busy_ms_per_step": busy,
                      "median_step_ms": steady,
                      "idle_share": 1.0 - busy / steady,
                      "top_kernels": top_kernels(prof, 1)}
    for name, ms, calls in out["profile"]["top_kernels"]:
        print(f"  train step kernel {name}: {ms:.2f} ms, {calls:.0f} calls")
    print(f"smollm-360m training: peak {out['peak_gib']:.2f} GiB "
          f"(max_memory_allocated; {out['allocated_before_gib']:.2f} GiB "
          f"allocated before the first step), median step {steady:.1f} ms, "
          f"{launches:.0f} launches a step, device busy {busy:.1f} ms a "
          f"step (idle share {1 - busy / steady:.1%}) [{card}]")
    # checkpoint: saved, restored into another seed's tree, bit for bit
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        save_checkpoint(tmp, tr.params, tr.opt_state, step=TRAIN_STEPS + 1)
        t1 = time.perf_counter()
        tmpl = Model(cfg).init(seed=1, device=dev)
        params, opt, step = restore_checkpoint(tmp, tmpl, adamw_init(tmpl))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    del tmpl
    assert step == TRAIN_STEPS + 1 and leaves_equal(params, tr.params) \
        and leaves_equal(opt, tr.opt_state), "checkpoint round trip"
    out["checkpoint"] = {"save_s": t1 - t0, "restore_s": t2 - t1}
    print(f"checkpoint: saved in {t1 - t0:.1f} s, restored in {t2 - t1:.1f} "
          f"s, parameters and AdamW state equal bit for bit")
    # the restored tree serves, as the in-memory one does
    for algorithm in ("shvs", "fused"):
        streams = {}
        for name, p in (("restored", params), ("in_memory", tr.params)):
            eng = family_engine(cfg, algorithm, dev, p)
            reqs = synth_requests(8, V, 16, greedy=True)
            rep = family_serve(eng, reqs, f"trained smollm-360m {name} "
                               f"{algorithm} greedy", card)
            eng.close()
            streams[name] = [r.output for r in reqs]
            out[f"serve_{algorithm}_{name}"] = rep
        launched = rep["launches"]
        assert streams["restored"] == streams["in_memory"], algorithm
        assert (launched["fused_sample"] if algorithm == "fused" else
                min(launched["penalty_scale"], launched["shvs_masses"])) \
            > 0, launched
    print("trained smollm-360m: restored and in-memory parameters serve "
          "equal greedy streams (shvs, fused)")
    del params, opt
    return out, tr


def long_sequence(tr, dev, card):
    """Phase 10 (b): a train step at B = 1, S = 4096 through
    ``attend_chunked``, then a prefill at S = 4608 in f32, chunked against
    ``attend_full``."""
    import dataclasses
    import torch
    from repro_torch.models import attention
    from repro_torch.models.model import Model
    from repro_torch.training.data import DataConfig, SyntheticDataset
    cfg = tr.model.cfg
    V = cfg.vocab_size
    out = {}
    batch = to_dev(SyntheticDataset(DataConfig(
        vocab_size=V, seq_len=LONG_TRAIN_S, batch_size=1, seed=1))
        .sample_batch(), dev)
    ctx, calls = counted(attention, "attend_chunked")
    with ctx:
        out["train_step"] = train_step_once(tr.model, tr.params, batch, dev,
                                            card, "smollm-360m S=4096")
    # the forward, the recompute, once a layer each
    assert calls[0] == 2 * cfg.num_layers, calls
    out["train_step"]["attend_chunked_calls"] = calls[0]
    m32 = Model(dataclasses.replace(cfg, dtype="float32"))
    p32 = _cast(tr.params, torch.float32)
    toks = torch.as_tensor(SyntheticDataset(DataConfig(
        vocab_size=V, seq_len=LONG_PREFILL_S, batch_size=2, seed=2))
        .sample_batch()["tokens"], device=dev)
    runs = {}
    for name in ("chunked", "full"):
        plain = attention.attend_full if name == "full" else \
            attention.attend_chunked
        with swapped(attention, "attend_chunked", plain):
            cache = m32.init_cache(2, LONG_PREFILL_S, device=dev)
            reset_peak()
            t0 = time.perf_counter()
            logits, cache = m32.prefill(p32, {"tokens": toks}, cache)
            torch.cuda.synchronize()
            runs[name] = (logits, cache, (time.perf_counter() - t0) * 1e3,
                          gib())
    (lc, cc, ms_c, gb_c), (lf, cf, ms_f, gb_f) = runs["chunked"], runs["full"]
    rel = ((lc - lf).abs().max() / lf.abs().max()).item()
    kv_rel = max(((cc[k] - cf[k]).abs().max() / cf[k].abs().max()).item()
                 for k in ("k", "v"))
    top = lf.topk(2, dim=-1).values
    clear = (top[:, 0] - top[:, 1]) >= GAP_CLEAR
    same = lc.argmax(-1) == lf.argmax(-1)
    out["prefill_4608_f32"] = {
        "max_rel_err_logits": rel, "max_rel_err_kv": kv_rel,
        "argmax_equal": int(same.sum()), "clear_rows": int(clear.sum()),
        "chunked_ms": ms_c, "full_ms": ms_f, "chunked_peak_gib": gb_c,
        "full_peak_gib": gb_f}
    print(f"prefill S={LONG_PREFILL_S} f32 (B=2): chunked vs attend_full max "
          f"rel err logits {rel:.3g}, K/V {kv_rel:.3g}; argmax equal on "
          f"{int(same.sum())}/2 rows ({int(clear.sum())} with a clear gap); "
          f"chunked {ms_c:.1f} ms, peak {gb_c:.2f} GiB; full {ms_f:.1f} ms, "
          f"peak {gb_f:.2f} GiB [{card}]")
    assert rel < CHUNK_REL_TOL and kv_rel < CHUNK_REL_TOL, out
    assert bool((same | ~clear).all()), out
    del runs, p32, lc, lf, cc, cf
    torch.cuda.empty_cache()
    return out


def vlm_phase(dev, card):
    """Phase 10 (c): internvl2-2b, served text only, then its patch
    embeddings through ``Model.prefill`` and a train step."""
    import torch
    from repro_torch.launch.serve import serve_batch, synth_requests
    from repro_torch.models.layers import torch_dtype
    from repro_torch.models.model import Model
    from repro_torch.training.optimizer import tree_leaves
    cfg = full_arch("internvl2-2b")
    assert not cfg.tie_embeddings
    V = cfg.vocab_size
    model = Model(cfg)
    params = model.init(seed=0, device=dev)
    out = {"parameters": sum(t.numel() for t in tree_leaves(params))}
    print(f"internvl2-2b full width: {out['parameters']} parameters (bf16, "
          f"untied head)")
    greedy = {}
    for algorithm in ("shvs", "fused"):
        eng = family_engine(cfg, algorithm, dev, params)
        serve_batch(eng, synth_requests(2, V, 2, rng_seed=99, seed=0))
        runs = []
        for run in range(2):
            reqs = synth_requests(8, V, FAMILY_NEW, seed=0)
            out[f"{algorithm}_run{run}"] = family_serve(
                eng, reqs, f"internvl2-2b {algorithm} run {run}", card)
            runs.append([r.output for r in reqs])
        assert runs[0] == runs[1], (algorithm, "two runs differ")
        launched = out[f"{algorithm}_run0"]["launches"]
        assert (launched["fused_sample"] if algorithm == "fused" else
                min(launched["penalty_scale"], launched["shvs_masses"])) \
            > 0, launched
        greedy[algorithm] = synth_requests(8, V, FAMILY_NEW, greedy=True)
        serve_batch(eng, greedy[algorithm])
        eng.close()
    eng = family_engine(cfg, "reference", dev, params)
    greedy["reference"] = synth_requests(8, V, FAMILY_NEW, greedy=True)
    serve_batch(eng, greedy["reference"])
    out["greedy"] = {f"{a}_vs_reference": gap_checked(
        eng, greedy[a], greedy["reference"], dev, "internvl2-2b")
        for a in ("shvs", "fused")}
    eng.close()
    print(f"internvl2-2b: two runs equal (shvs, fused); greedy vs reference "
          f"{out['greedy']} [{card}]")
    gen = torch.Generator(device=dev).manual_seed(5)
    patches = lambda B: torch.randn((B, PATCHES, cfg.d_model), generator=gen,
                                    device=dev).to(torch_dtype(cfg.dtype))
    toks = torch.randint(1, V, (2, 32), generator=gen, device=dev,
                         dtype=torch.int32)
    out["patch_decode"] = plane_decode(
        model, params, {"tokens": toks, "patch_embeds": patches(2)}, dev,
        card, f"internvl2-2b {PATCHES} patches + 32 tokens", seq=512)
    assert out["patch_decode"]["len"] == [PATCHES + 32 + 16] * 2
    lab = torch.randint(0, V, (2, TRAIN_S + 1), generator=gen, device=dev,
                        dtype=torch.int32)
    out["train_step"] = train_step_once(
        model, params, {"tokens": lab[:, :-1], "labels": lab[:, 1:],
                        "patch_embeds": patches(2)}, dev, card,
        f"internvl2-2b {PATCHES} patches +")
    del params, model
    torch.cuda.empty_cache()
    return out


def audio_phase(dev, card):
    """Phase 10 (d): whisper-base over seeded encoder frames: the
    encoder's ms, prefill + decode drawn through ``DecisionPlane.step``,
    the prefill/decode consistency, a train step, and the engines'
    refusal (ROADMAP Fault 7)."""
    import statistics
    import torch
    from repro_torch.models.layers import torch_dtype
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import apply_encoder
    cfg = full_arch("whisper-base")
    assert cfg.encoder.num_frames == FRAMES
    V = cfg.vocab_size
    model = Model(cfg)
    params = model.init(seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    frames = torch.randn((2, FRAMES, cfg.d_model), generator=gen,
                         device=dev).to(torch_dtype(cfg.dtype))
    times = []
    for i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = apply_encoder(params["encoder"], frames, cfg)
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
    assert enc.shape == frames.shape and bool(torch.isfinite(enc).all())
    out = {"encoder_ms": statistics.median(times)}
    print(f"whisper-base encoder, B=2 x {FRAMES} frames: "
          f"{out['encoder_ms']:.2f} ms (median of 3) [{card}]")
    toks = torch.randint(1, V, (2, 8), generator=gen, device=dev,
                         dtype=torch.int32)
    out["frames_decode"] = plane_decode(
        model, params, {"tokens": toks, "frames": frames}, dev, card,
        f"whisper-base {FRAMES} frames + 8 tokens", seq=64)
    out["consistency"] = family_consistency(model, params, dev, card,
                                            extra={"frames": frames})
    lab = torch.randint(0, V, (2, TRAIN_S + 1), generator=gen, device=dev,
                        dtype=torch.int32)
    out["train_step"] = train_step_once(
        model, params, {"tokens": lab[:, :-1], "labels": lab[:, 1:],
                        "frames": frames}, dev, card,
        f"whisper-base {FRAMES} frames +")
    try:
        family_engine(cfg, "shvs", dev, params)
    except NotImplementedError as e:
        assert "Fault 7" in str(e), e
        out["engine_refused"] = str(e)
    else:
        raise AssertionError("whisper-base: the engine accepted it")
    print(f"whisper-base: the engine refuses it ({out['engine_refused']})")
    del params, model
    torch.cuda.empty_cache()
    return out


def train_phase(dev, card):
    """Phase 10: (a) full-width smollm-360m trained, checkpointed and
    served, (b) the long sequence, (c) internvl2-2b, (d) whisper-base."""
    import torch
    out, secs, t0 = {}, {}, time.perf_counter()
    out["smollm"], tr = train_smollm(dev, card)
    secs["a"] = time.perf_counter() - t0
    out["long"] = long_sequence(tr, dev, card)
    secs["b"] = time.perf_counter() - t0 - sum(secs.values())
    del tr
    torch.cuda.empty_cache()
    out["internvl2"] = vlm_phase(dev, card)
    secs["c"] = time.perf_counter() - t0 - sum(secs.values())
    out["whisper"] = audio_phase(dev, card)
    secs["d"] = time.perf_counter() - t0 - sum(secs.values())
    out["seconds"] = secs
    print(f"phase 10 parts took (s): "
          f"{ {k: round(v, 1) for k, v in secs.items()} }")
    return out


def train_only(dev, card):
    """``--train-only``: phase 10 alone; prints one JSON line."""
    print(json.dumps({"train_only": {"card": card,
                                     "runs": train_phase(dev, card)}}))
    return 0


# ---------------------------------------------------------------------------
# phase 11: distribution — the decision planes and the EP MoE on a mesh
# ---------------------------------------------------------------------------
DIST_MESHES = ((1, 4), (2, 2))        # (data, model) of the four ranks
DIST_STEPS = 4                        # smollm logits each plane decides
DIST_PROMPT = 32                      # prompt tokens (the engine's bucket)
DIST_NEW = 4                          # granite greedy tokens through EP
GRANITE = "granite-moe-1b-a400m"
# (name, mode, the distributed plane's algorithm, the single-device
# comparator's, params): hierarchical is held to shvs on unfiltered and
# greedy rows and to truncation_first on filtered rows, as the reference's
# own check does
DIST_RUNS = (("sp_shvs", "sequence_parallel", "shvs", "shvs", "mixed"),
             ("sp_fused", "sequence_parallel", "fused", "fused", "mixed"),
             ("sp_gumbel", "sequence_parallel", "gumbel", "gumbel", "mixed"),
             ("vocab_gather", "vocab_gather", "shvs", "shvs", "mixed"),
             ("hier", "hierarchical", "shvs", "shvs", "unfiltered"),
             ("hier_filtered", "hierarchical", "shvs", "truncation_first",
              "filtered"))
# the kernels each run must launch on every rank
DIST_KERNELS = {"sp_shvs": ("penalty_scale", "shvs_masses"),
                "sp_fused": ("fused_sample",),
                "sp_gumbel": ("penalty_scale", "gumbel_argmax"),
                "vocab_gather": ("penalty_scale", "shvs_masses"),
                "hier": ("penalty_scale",), "hier_filtered": ("penalty_scale",)}


def dist_params(kind, B, dev):
    """Per-row sampling controls of phase 11's runs: "mixed" cycles
    unfiltered τ = 0.8, greedy, top-k 50 and top-p 0.9 rows; "unfiltered"
    alternates τ = 0.8 and greedy; "filtered" top-k 50 and top-p 0.9;
    each with repetition 1.2, presence 0.1, frequency 0.05. "greedy":
    argmax rows without penalties (an engine's greedy request)."""
    import torch
    from repro_torch.core.sampling import SamplingParams
    rows = {"mixed": [(0.8, 0, 1.0), (0.0, 0, 1.0), (0.9, 50, 1.0),
                      (0.8, 0, 0.9)],
            "unfiltered": [(0.8, 0, 1.0), (0.0, 0, 1.0)],
            "filtered": [(0.9, 50, 1.0), (0.8, 0, 0.9)],
            "greedy": [(0.0, 0, 1.0)]}[kind]
    pen = (1.0, 0.0, 0.0) if kind == "greedy" else (1.2, 0.1, 0.05)
    rows = [rows[b % len(rows)] for b in range(B)]
    f = lambda i, dt: torch.tensor([r[i] for r in rows], dtype=dt,
                                   device=dev)
    full = lambda v: torch.full((B,), v, dtype=torch.float32, device=dev)
    return SamplingParams(
        temperature=f(0, torch.float32), top_k=f(1, torch.int32),
        top_p=f(2, torch.float32), min_p=full(0.0),
        repetition_penalty=full(pen[0]), presence_penalty=full(pen[1]),
        frequency_penalty=full(pen[2]))


def dist_plane(V, algorithm, mode, dev):
    from repro_torch.config import SHVSConfig
    from repro_torch.core.decision_plane import DecisionPlane
    return DecisionPlane(V, algorithm=algorithm,
                         shvs=SHVSConfig(hot_size=H_MAIN),
                         sampling_parallelism=mode, k_cap=K_CAP, seed=0,
                         device=dev)


def dist_bytes(mode, B, V, dp, tp, kc=K_CAP):
    """Bytes a rank receives a decision step, reckoned from the shapes
    (f32 logits, int32 tokens, int64 draws)."""
    b = B // dp
    if mode == "vocab_gather":
        return b * V * (tp - 1) // tp * 4
    if mode == "sequence_parallel":
        return b * (V // tp) * (tp - 1) // tp * 4 + b // tp * (tp - 1) * 4
    # pmax of (b,), the gather of (b, 2·kc + 4), the psum of (2, b) int64
    return (tp - 1) * (b * 4 + b * (2 * kc + 4) * 4 + 2 * b * 8)


def check_rank_shapes(dev):
    """Each kernel against its plain version at the shapes phase 11's
    ranks give it: S1 rows (2, 49152) and data rows (4 and 8, 49152), and
    the hierarchical blocks (8, 12288) and (4, 24576); ``gumbel_argmax``
    of rows from ``row0`` on equals those rows of the whole batch's."""
    import torch
    from repro_torch.kernels import (fused_kernel, gumbel_kernel,
                                     penalty_kernel, ref, shvs_kernel)
    gen = torch.Generator(device=dev).manual_seed(11)
    err = {}
    for B, V in ((2, V_MAIN), (4, V_MAIN), (8, V_MAIN // 4),
                 (4, V_MAIN // 2)):
        x = make_inputs(B, V, gen, dev)
        args = (x["z"], x["cp"], x["co"], x["rep"], x["pres"], x["freq"],
                x["temp"])
        got, want = penalty_kernel.penalty_scale(*args), ref.penalty_ref(*args)
        assert torch.equal(got, want), ("penalty_scale", B, V)
        err["penalty_scale"] = 0.0
        if V != V_MAIN:
            continue
        hot = hot_mask(V, "first", dev)
        g, w = shvs_kernel.shvs_masses(want, hot), ref.shvs_mass_ref(want, hot)
        assert torch.equal(g[0], w[0]) and torch.equal(g[3], w[3])
        for a, b in zip(g[1:3], w[1:3]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=0)
        err["shvs_masses"] = max(err.get("shvs_masses", 0.0), max(
            (a - b).abs().max().item() for a, b in zip(g, w)))
        f_args = args + (x["top_k"], x["top_p"], x["min_p"], x["u"], hot)
        g = fused_kernel.fused_sample(*f_args, k_cap=K_CAP, block_v=BLOCK_V)
        w = ref.fused_sample_ref(*f_args, k_cap=K_CAP, block_v=BLOCK_V)
        for i in (0, 1, 3):
            assert torch.equal(g[i], w[i]), ("fused_sample", B, V, i)
        torch.testing.assert_close(g[2], w[2], rtol=1e-5, atol=0)
        err["fused_sample"] = max(err.get("fused_sample", 0.0),
                                  (g[2] - w[2]).abs().max().item())
    z = torch.randn((B_MAIN, V_MAIN), generator=gen, device=dev) * 2.0
    whole = gumbel_kernel.gumbel_argmax(z, 77)
    for row0 in (0, 2, 6):
        got = gumbel_kernel.gumbel_argmax(z[row0:row0 + 2].contiguous(), 77,
                                          row0)
        assert torch.equal(got, ref.gumbel_argmax_ref(z[row0:row0 + 2], 77,
                                                      row0)), row0
        assert torch.equal(got, whole[row0:row0 + 2]), row0
    err["gumbel_argmax"] = 0.0
    torch.cuda.synchronize()
    print(f"phase 11 kernel checks at the ranks' shapes ((2|4|8, 49152), "
          f"(8, 12288), (4, 24576); gumbel rows from row0 2 and 6): ok, "
          f"max abs err {err}")
    # times at an S1 rank's rows and a hierarchical rank's block (1, 4),
    # warm in L2 as the decode step finds them
    out = {"max_abs_err": err}
    for shape, (B, V) in (("sp_rows", (2, V_MAIN)),
                          ("hier_block", (B_MAIN, V_MAIN // 4))):
        timing, bounds = time_kernels(B, V, gen, dev, 1, 1), \
            kernel_bounds(B, V)
        out[shape] = {}
        for name, (k_ms, p_ms, kl_ms, _) in timing.items():
            b_ms, b_by, _ = bounds[name]
            out[shape][name] = {"ms": k_ms, "launch_ms": kl_ms,
                                "plain_ms": p_ms, "bound_ms": b_ms,
                                "bound_by": b_by}
            print(f"phase 11 {name} at ({B}, {V}): {k_ms:.4f} ms device "
                  f"({kl_ms:.4f} with launch), plain {p_ms:.4f} ms, bound "
                  f"{b_ms:.5f} ms ({b_by}), share {b_ms / k_ms:.1%} "
                  f"[{card_line()}]")
    return out


def dist_one_rank(dev, card):
    """Phase 11 (a): a (1, 1) mesh over NCCL in this process serves
    full-width smollm-360m, batch 8, with the plane in each mode; the
    streams must equal the run without a mesh, bit for bit."""
    import dataclasses
    import socket
    import torch.distributed as tdist
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.serve import (build_engine, serve_batch,
                                          synth_requests)
    from repro_torch.models import dist
    from repro_torch.models.model import Model
    from repro_torch.config import get_arch
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    tdist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                             world_size=1, rank=0, device_id=dev)
    try:
        mesh = make_local_mesh(1, 1)
        params = Model(get_arch("smollm-360m")).init(seed=0, device=dev)

        def run(mode, on_mesh):
            eng = build_engine("smollm-360m", False, "shvs", B_MAIN, 256,
                               device=dev, params=params,
                               sampling_parallelism=mode)
            reqs = synth_requests(8, V_MAIN, 16, seed=0)
            for i, r in enumerate(reqs):
                r.sampling = dataclasses.replace(
                    r.sampling, top_k=0, top_p=1.0,
                    temperature=0.0 if i % 2 else 0.8)
            with dist.use_mesh(mesh if on_mesh else None):
                rep = serve_batch(eng, reqs)
            eng.close()
            return [r.output for r in reqs], rep

        want, _ = run("sequence_parallel", False)
        out = {}
        for mode in ("sequence_parallel", "vocab_gather", "hierarchical"):
            got, rep = run(mode, True)
            assert got == want, (mode, got, want)
            out[mode] = {"tpot_p50_ms": rep["tpot_p50_ms"],
                         "tokens": rep["tokens"]}
            print(f"phase 11 (a) (1, 1) NCCL mesh, {mode}: streams equal "
                  f"the run without a mesh ({rep['tokens']} tokens), TPOT "
                  f"p50 {rep['tpot_p50_ms']:.2f} ms [{card}]")
        out["collectives"] = dist.collective_stats()
        dist.reset_collective_stats()
        assert out["collectives"], "the (1, 1) mesh ran no NCCL collective"
    finally:
        tdist.destroy_process_group()
    return out


def dist_prepare(dev, work):
    """The single-process side of phase 11 (b): smollm-360m's decode logits
    (prefill + greedy decode at B = 8) and the single-device plane's tokens
    and histograms over them for each run; granite's engine streams
    (greedy, 32-token prompts). Written to ``work`` for the ranks."""
    import numpy as np
    import torch
    from repro_torch.config import get_arch
    from repro_torch.launch.serve import serve_batch
    from repro_torch.engine.request import Request
    from repro_torch.config import SamplingConfig
    from repro_torch.models.model import Model
    rs = np.random.default_rng(11)
    cfg = get_arch("smollm-360m")
    model = Model(cfg)
    params = model.init(seed=0, device=dev)
    prompts = torch.from_numpy(rs.integers(1, V_MAIN, (B_MAIN, DIST_PROMPT))
                               ).to(dev)
    with torch.no_grad():
        cache = model.init_cache(B_MAIN, 256, device=dev)
        lg, cache = model.prefill(params, {"tokens": prompts}, cache)
        logits = [lg]
        for _ in range(DIST_STEPS - 1):
            lg, cache = model.decode_step(params, lg.argmax(-1), cache)
            logits.append(lg)
    logits = torch.stack(logits)
    del params, cache
    single = {}
    for name, mode, _, cmp, kind in DIST_RUNS:
        plane = dist_plane(V_MAIN, cmp, "sequence_parallel", dev)
        st = plane.init_state(B_MAIN, prompt_tokens=prompts)
        p = dist_params(kind, B_MAIN, dev)
        toks = []
        for s in range(DIST_STEPS):
            t, st, _ = plane.step(logits[s], st, p, s)
            toks.append(t)
        single[name] = {"tokens": torch.stack(toks).cpu(),
                        "counts": st.output_counts.cpu()}
    torch.save({"logits": logits.cpu(), "prompts": prompts.cpu(),
                "single": single}, work / "smollm.pt")

    gcfg = get_arch(GRANITE)
    gparams = Model(gcfg).init(seed=0, device=dev)
    gprompts = rs.integers(1, gcfg.vocab_size, (B_MAIN, DIST_PROMPT))
    eng = family_engine(GRANITE, "shvs", dev, gparams)
    reqs = [Request(request_id=i, prompt=gprompts[i].tolist(),
                    max_new_tokens=DIST_NEW,
                    sampling=SamplingConfig(greedy=True))
            for i in range(B_MAIN)]
    serve_batch(eng, reqs)
    torch.save({"prompts": torch.from_numpy(gprompts)}, work / "granite.pt")
    return single, eng, reqs


def dist_four_ranks(dev, card, work):
    """Phase 11 (b): four ranks spawned on this card (``dev``), over gloo;
    the kernel library is already built, so they only load it."""
    import os
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "2"
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--dist-rank", str(r),
         "--dist-world", "4", "--dist-port", str(port), "--dist-dir",
         str(work), "--dist-device", str(dev)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(4)]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    logdir = ROOT / "chiprun_out"
    logdir.mkdir(exist_ok=True)
    for r, (p, log) in enumerate(zip(procs, logs)):
        (logdir / f"dist_rank{r}.log").write_text(log)
        if p.returncode != 0:
            print(log[-6000:])
        assert p.returncode == 0, f"rank {r} exited with {p.returncode}"
    return json.loads((work / "ranks.json").read_text())


def dist_rank_main(args):
    """One of phase 11 (b)'s four ranks: every plane run and the EP MoE on
    both meshes; rank 0 writes ``ranks.json``."""
    import dataclasses
    import torch
    import torch.distributed as tdist
    from repro_torch.config import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import dist, moe
    from repro_torch.models.model import Model
    work = Path(args.dist_dir)
    dev = torch.device(args.dist_device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    rank = args.dist_rank
    tdist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                             f"{args.dist_port}", world_size=args.dist_world,
                             rank=rank)
    sm = torch.load(work / "smollm.pt")
    gp = torch.load(work / "granite.pt")["prompts"]
    gcfg = get_arch(GRANITE)
    gmodel = Model(gcfg)
    gfull = gmodel.init(seed=0, device=dev)
    out = {}

    def block(x, spec, mesh):
        return sharding.local_shard(x, spec, mesh).contiguous()

    for shape in DIST_MESHES:
        mesh = make_local_mesh(*shape)
        tag = f"{shape[0]}x{shape[1]}"
        dp, tp = shape
        with dist.use_mesh(mesh):
            r0, n = dist.rows(B_MAIN, ("data",))
            for name, mode, algo, _, kind in DIST_RUNS:
                plane = dist_plane(V_MAIN, algo, mode, dev)
                st = plane.init_state(B_MAIN, prompt_tokens=sm["prompts"]
                                      .to(dev))
                specs = sharding.decision_state_shardings(
                    st, mesh, ("data",), mode)
                st = type(st)(*(block(x, s, mesh) for x, s in zip(st, specs)))
                p = dist_params(kind, B_MAIN, dev)
                zs = [block(sm["logits"][s].to(dev), ("data", "model"), mesh)
                      for s in range(DIST_STEPS)]
                plane.step(zs[0], st, p, 0)          # warm-up: not counted
                sync(dev)
                dist.reset_collective_stats()
                dist.set_timing(True)
                ops.reset_launch_counts()
                toks, t0 = [], time.perf_counter()
                for s in range(DIST_STEPS):
                    t, st, _ = plane.step(zs[s], st, p, s)
                    toks.append(t)
                sync(dev)
                wall = (time.perf_counter() - t0) * 1e3 / DIST_STEPS
                launches = ops.launch_counts()
                dist.set_timing(False)
                coll = dist.collective_stats()
                toks = torch.stack(toks)
                counts = st.output_counts
                if mode == "hierarchical":
                    counts = dist.all_gather(counts, "model", dim=1,
                                             tiled=True)
                    rows_axes = ("data",)
                elif mode == "sequence_parallel":
                    rows_axes = ("data", "model")
                else:
                    rows_axes = ("data",)
                counts = dist.all_gather(counts, rows_axes, dim=0, tiled=True)
                toks = dist.all_gather(toks, "data", dim=1, tiled=True)
                want = sm["single"][name]
                ok = torch.equal(toks.cpu(), want["tokens"]) and \
                    torch.equal(counts.cpu(), want["counts"])
                rec = {"ok": ok, "step_ms": wall, "launches": launches,
                       "collective_ms": 1e3 * sum(
                           c["seconds"] for c in coll.values()) / DIST_STEPS,
                       "collectives": coll,
                       "bytes_reckoned": dist_bytes(mode, B_MAIN, V_MAIN,
                                                    dp, tp),
                       "logits_block": list(zs[0].shape), "state": list(
                           st.output_counts.shape)}
                if not ok:
                    rec["tokens"] = toks.tolist()
                    rec["want"] = want["tokens"].tolist()
                out.setdefault(tag, {}).setdefault(name, {})[rank] = rec
                print(f"{tag} {name}: logits block {rec['logits_block']}, "
                      f"state {rec['state']}, step "
                      f"{wall:.3f} ms, collectives "
                      f"{rec['collective_ms']:.3f} ms, launches {launches}, "
                      f"equal to the single device: {ok}")

            # granite: greedy decode through the EP MoE
            gp_loc = sharding.shard_tree(gfull, mesh, gcfg)
            plane = dist_plane(gcfg.vocab_size, "shvs", "sequence_parallel",
                               dev)
            greedy = dist_params("greedy", B_MAIN, dev)
            st = plane.init_state(B_MAIN)
            specs = sharding.decision_state_shardings(
                st, mesh, ("data",), "sequence_parallel")
            st = type(st)(*(block(x, s, mesh) for x, s in zip(st, specs)))
            cache = gmodel.init_cache(n, 256, device=dev)
            x_probe = torch.zeros((n, 1, gcfg.d_model), dtype=torch.bfloat16,
                                  device=dev)
            path = "scatter" if moe._prefer_scatter(
                x_probe, gcfg, dist.get_ctx()) else "gather"
            ops.reset_launch_counts()
            dist.reset_collective_stats()
            sync(dev)
            t0 = time.perf_counter()
            with torch.no_grad():
                lg, cache = gmodel.prefill(
                    gp_loc, {"tokens": gp[r0:r0 + n].to(dev)}, cache)
                toks = []
                for i in range(DIST_NEW):
                    t, st, _ = plane.step(lg, st, greedy, i)
                    toks.append(t)
                    if i + 1 < DIST_NEW:
                        lg, cache = gmodel.decode_step(gp_loc, t, cache)
            sync(dev)
            g_ms = (time.perf_counter() - t0) * 1e3
            toks = dist.all_gather(torch.stack(toks, 1), "data", dim=0,
                                   tiled=True)
            g_rec = {"path": path, "tokens": toks.tolist(), "ms": g_ms,
                     "launches": ops.launch_counts(),
                     "expert_block": list(gp_loc["stack"]["moe"]["w_gate"]
                                          .shape),
                     "collectives": dist.collective_stats()}
            # the MoE layer alone in f32: EP against the local path
            mp = {k: gfull["stack"]["moe"][k][0].float()
                  for k in ("router", "w_gate", "w_up", "w_down")}
            gen = torch.Generator(device=dev).manual_seed(5)
            x = 0.5 * torch.randn((B_MAIN, 4, gcfg.d_model), generator=gen,
                                  device=dev)
            cfg32 = dataclasses.replace(gcfg, dtype="float32")
            with dist.use_mesh(None):
                y_loc, _ = moe.apply_moe(mp, x, cfg32)
            mp_blk = sharding.shard_tree({"stack": {"moe": mp}}, mesh,
                                         cfg32)["stack"]["moe"]
            y_ep, _ = moe.apply_moe(mp_blk, x[r0:r0 + n], cfg32)
            want = y_loc[r0:r0 + n]
            g_rec["moe_f32_err_over_tol"] = float(
                ((y_ep - want).abs() / (2e-4 + 2e-4 * want.abs())).max())
            g_rec["moe_f32_max_abs_err"] = float((y_ep - want).abs().max())
            out.setdefault(tag, {}).setdefault("granite", {})[rank] = g_rec
            print(f"{tag} granite EP ({path}): experts "
                  f"{g_rec['expert_block']}, {DIST_NEW} greedy tokens in "
                  f"{g_ms:.1f} ms, launches {g_rec['launches']}, MoE f32 "
                  f"max abs err {g_rec['moe_f32_max_abs_err']:.3g}")
            del gp_loc
    out["staged"] = list(dist.staged_collectives())
    gathered = [None] * args.dist_world
    tdist.all_gather_object(gathered, out)
    if rank == 0:
        merged = {"staged": sorted({s for o in gathered for s in o["staged"]})}
        for o in gathered:
            for tag, runs in o.items():
                if tag == "staged":
                    continue
                for name, per in runs.items():
                    merged.setdefault(tag, {}).setdefault(name, {}).update(
                        {str(k): v for k, v in per.items()})
        (work / "ranks.json").write_text(json.dumps(merged))
    tdist.barrier()
    tdist.destroy_process_group()
    return 0


def sync(dev):
    """Wait for ``dev``'s stream (nothing to wait for on the CPU)."""
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def dist_phase(dev, card):
    """Phase 11: (a) the one-rank NCCL mesh; kernel checks at the ranks'
    shapes; (b) the four gloo ranks on this card, their results held to
    the single-device plane and the single-process granite engine."""
    import shutil
    import tempfile
    t0 = time.perf_counter()
    out = {"kernels": check_rank_shapes(dev)}
    out["one_rank_nccl"] = dist_one_rank(dev, card)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_dist_"))
    try:
        single, eng, greqs = dist_prepare(dev, work)
        ranks = dist_four_ranks(dev, card, work)
        print(f"phase 11 (b): collectives gloo staged through pinned host "
              f"memory: {ranks['staged'] or 'none'}")
        out["staged"] = ranks["staged"]
        for shape in DIST_MESHES:
            tag = f"{shape[0]}x{shape[1]}"
            runs = ranks[tag]
            for name, *_ in DIST_RUNS:
                per = runs[name]
                assert len(per) == 4, (tag, name, sorted(per))
                for r, rec in sorted(per.items()):
                    assert rec["ok"], (tag, name, r, rec.get("tokens"),
                                       rec.get("want"))
                    for k in DIST_KERNELS[name]:
                        assert rec["launches"][k] > 0, (tag, name, r,
                                                        rec["launches"])
                step = max(rec["step_ms"] for rec in per.values())
                coll = max(rec["collective_ms"] for rec in per.values())
                print(f"phase 11 (b) {tag} {name}: tokens and histograms "
                      f"equal the single device on all 4 ranks; slowest "
                      f"rank {step:.3f} ms a step, {coll:.3f} ms of it in "
                      f"collectives (host clock, one card: no cross-card "
                      f"time); {per['0']['bytes_reckoned']} B received a "
                      f"rank a step (reckoned); launches per rank "
                      f"{[{k: v for k, v in per[str(r)]['launches'].items() if v} for r in range(4)]} "
                      f"[{card}]")
            g = runs["granite"]
            toks = [g[str(r)]["tokens"] for r in range(4)]
            assert all(t == toks[0] for t in toks), "ranks disagree"
            for r in range(4):
                assert g[str(r)]["moe_f32_err_over_tol"] <= 1.0, g[str(r)]
            got = [copy.copy(q) for q in greqs]
            for q, t in zip(got, toks[0]):
                q.output = list(t)
            cmp = gap_checked(eng, greqs, got, dev, f"granite EP {tag}")
            print(f"phase 11 (b) {tag} granite EP path {g['0']['path']}: "
                  f"greedy agreement with the single-process engine "
                  f"{cmp['agreement']:.3f} (first difference "
                  f"{cmp['first_difference']}); MoE layer f32 max abs err "
                  f"{max(g[str(r)]['moe_f32_max_abs_err'] for r in range(4)):.3g}"
                  f" [{card}]")
            runs["granite_agreement"] = cmp
        out["four_ranks"] = ranks
        eng.close()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 11 took {out['seconds']:.1f} s")
    return out


def dist_only(dev, card):
    """``--dist-only``: phase 11 alone; prints one JSON line."""
    print(json.dumps({"dist_only": {"card": card,
                                    "runs": dist_phase(dev, card)}}))
    return 0


# ---------------------------------------------------------------------------
# phase 12: tensor-parallel serving — launch/steps.py's programs with the
# model forward split over the mesh's model axis
# ---------------------------------------------------------------------------
TP_B, TP_PROMPT, TP_CACHE = 8, 64, 256   # batch, prompt, the serve cache
TP_STEPS = 8                             # serve steps of smollm-360m
TP_MESHES = ((1, 4), (2, 2))
# (arch, layers or None, meshes, algorithms, serve steps, dtype):
# smollm-360m at full depth on both meshes, every algorithm at (1, 4); the
# other families at (1, 4), full width, depth cut to keep the phase within
# its time. Zamba2 runs in float32: with seeded bf16 weights its logits
# move by O(1) under any change of rounding order (phase 9 (b): prefill(21)
# + 3 decode against prefill(24) differ by 0.797 relative), past any gap
# rule, as its TP forward's partial sums in another order do too
TP_RUNS = (("smollm-360m", None, TP_MESHES, ("shvs", "fused", "gumbel"),
            TP_STEPS, "bfloat16"),
           ("granite-moe-1b-a400m", 8, ((1, 4),), ("shvs",), 3, "bfloat16"),
           ("rwkv6-3b", 8, ((1, 4),), ("shvs",), 3, "bfloat16"),
           ("zamba2-1.2b", 12, ((1, 4),), ("shvs",), 3, "float32"))
TP_KERNELS = {"shvs": ("penalty_scale", "shvs_masses"),
              "fused": ("fused_sample",),
              "gumbel": ("penalty_scale", "gumbel_argmax")}


def tp_config(arch, layers, dtype="bfloat16"):
    import dataclasses
    from repro_torch.config import get_arch
    cfg = get_arch(arch)
    assert cfg.dtype == "bfloat16", arch
    return dataclasses.replace(cfg, num_layers=layers or cfg.num_layers,
                               dtype=dtype)


def tp_shapes():
    from repro_torch.config import ShapeConfig
    return (ShapeConfig("tp_prefill", TP_PROMPT, TP_B, "prefill"),
            ShapeConfig("tp_decode", TP_CACHE, TP_B, "decode"))


def pad_cache(cache, slots):
    """A whole cache whose K/V hold ``slots`` positions: the prefill
    program's cache (its prompt's slots) padded with empty slots for the
    serve steps."""
    import torch
    out = dict(cache)
    for k in ("k", "v"):
        if k in out:
            x = out[k]
            out[k] = torch.cat([x, x.new_zeros(x.shape[:2] + (
                slots - x.shape[2],) + x.shape[3:])], dim=2)
    return out


def tp_reference(dev, work):
    """The single-process side of phase 12 (b) and (c): for each arch,
    seeded prompts, the prefill's and ``steps`` greedy decode steps'
    logits (whole rows, f32) and tokens of the unsplit model (prefill into
    the prompt's slots, then decode in the cache padded to TP_CACHE, as the
    programs run), written to ``work`` for the ranks."""
    import numpy as np
    import torch
    from repro_torch.models.model import Model
    out = {}
    for arch, layers, _, _, n, dtype in TP_RUNS:
        cfg = tp_config(arch, layers, dtype)
        model = Model(cfg)
        params = model.init(seed=0, device=dev)
        prompts = torch.from_numpy(np.random.default_rng(12).integers(
            1, cfg.vocab_size, (TP_B, TP_PROMPT))).to(dev)
        with torch.no_grad():
            cache = model.init_cache(TP_B, TP_PROMPT, device=dev)
            lg, cache = model.prefill(params, {"tokens": prompts}, cache)
            cache = pad_cache(cache, TP_CACHE)
            logits, toks = [lg], [lg.argmax(-1)]
            for _ in range(n):
                lg, cache = model.decode_step(params, toks[-1], cache)
                logits.append(lg)
                toks.append(lg.argmax(-1))
        out[arch] = {"prompts": prompts.cpu(),
                     "logits": torch.stack(logits).cpu(),
                     "tokens": torch.stack(toks).cpu()}
        del params, cache
    torch.save(out, work / "tp_ref.pt")


def tp_programs(cfg, mesh, algorithm, dev):
    from repro_torch.launch import steps
    pre_shape, dec_shape = tp_shapes()
    pre = steps.make_prefill_program(cfg, pre_shape, mesh, device=dev)
    dec = steps.make_serve_step_program(cfg, dec_shape, mesh,
                                        algorithm=algorithm, device=dev)
    return pre, dec


def tp_one_rank(dev, card):
    """Phase 12 (a): the prefill and 8 serve-step programs of full-width
    smollm-360m at B = 8 under a (1, 1) NCCL mesh in this process equal
    the same programs without a mesh bit for bit: tokens (mixed sampled
    and greedy rows, penalties on) and the K/V cache."""
    import socket
    import numpy as np
    import torch
    import torch.distributed as tdist
    from repro_torch.core import penalties as pen
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import dist
    from repro_torch.models.model import Model
    cfg = tp_config("smollm-360m", None)
    full = Model(cfg).init(seed=0, device=dev)
    prompts = torch.from_numpy(np.random.default_rng(12).integers(
        1, cfg.vocab_size, (TP_B, TP_PROMPT))).to(dev)
    sp = dist_params("mixed", TP_B, dev)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    tdist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                             world_size=1, rank=0, device_id=dev)

    def run(mesh):
        pre, dec = tp_programs(cfg, mesh, "shvs", dev)
        with dist.use_mesh(mesh, batch_axes=pre[4]), torch.no_grad():
            zeros = {k: torch.zeros(v.shape, dtype=v.dtype, device=dev)
                     for k, v in pre[1][2].items()}
            p, b, c, s_ = steps.local_inputs(
                cfg, (full, {"tokens": prompts}, zeros, sp), pre[2], mesh)
            tok, c = pre[0](p, b, c, s_)
            toks = [tok]
            st = pen.update_histograms(pen.init_state(
                TP_B, cfg.vocab_size, prompts), tok)
            _, c, st, tok, s_, _ = steps.local_inputs(
                cfg, (None, pad_cache(c, TP_CACHE), st, tok, sp, 0), dec[2],
                mesh)
            for i in range(TP_STEPS):
                tok, c, st = dec[0](p, c, st, tok, s_, i + 1)
                toks.append(tok)
            sync(dev)
        return torch.stack(toks), c
    try:
        want, c_want = run(None)
        got, c_got = run(make_local_mesh(1, 1))
    finally:
        tdist.destroy_process_group()
    assert torch.equal(got, want), (got.tolist(), want.tolist())
    assert torch.equal(c_got["k"], c_want["k"]) and \
        torch.equal(c_got["v"], c_want["v"])
    print(f"phase 12 (a) (1, 1) NCCL mesh: smollm-360m's prefill and "
          f"{TP_STEPS} serve-step programs (S1 shvs, mixed rows) equal the "
          f"programs without a mesh bit for bit: {TP_STEPS + 1} tokens a "
          f"row and the K/V cache [{card}]")
    return {"tokens_equal": True, "cache_equal": True,
            "tokens": got.tolist()}


def tp_four_ranks(dev, work):
    """Phase 12 (b), (c): four ranks spawned on this card over gloo; the
    kernel library is already built, so they only load it."""
    import os
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "2"
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--tp-rank", str(r),
         "--dist-world", "4", "--dist-port", str(port), "--dist-dir",
         str(work), "--dist-device", str(dev)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    logdir = ROOT / "chiprun_out"
    logdir.mkdir(exist_ok=True)
    for r, (p, log) in enumerate(zip(procs, logs)):
        (logdir / f"tp_rank{r}.log").write_text(log)
        if p.returncode != 0:
            print(log[-6000:])
        assert p.returncode == 0, f"rank {r} exited with {p.returncode}"
    return json.loads((work / "tp_ranks.json").read_text())


def tp_bound(cfg, t):
    """The analytic bound of one serve step (``launch/hlo_analysis``, H100
    SXM5 constants): (ms with a card a rank, ms of the four ranks' work
    on one card, the collective term over NVLink in ms)."""
    from repro_torch.launch import hlo_analysis as ha
    shape = tp_shapes()[1]
    byts = ha.analytic_memory_bytes(cfg, shape)
    flops = ha.model_flops_estimate(cfg, shape)
    per = ha.Roofline("tp", t, flops, byts, 0.0, flops)
    one = ha.Roofline("tp", 1, flops, byts, 0.0, flops)
    return (1e3 * max(per.compute_s, per.memory_s),
            1e3 * max(one.compute_s, one.memory_s))


def tp_rank_main(args):
    """One of phase 12's four ranks: each run of TP_RUNS on its meshes,
    the prefill program and teacher-forced serve-step programs (the
    single-process tokens as inputs, so the logits stay comparable);
    rank 0 writes ``tp_ranks.json``."""
    import torch
    import torch.distributed as tdist
    from repro_torch.core import penalties as pen
    from repro_torch.kernels import ops
    from repro_torch.launch import hlo_analysis as ha
    from repro_torch.launch import sharding, steps
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import dist
    from repro_torch.models.model import Model
    work = Path(args.dist_dir)
    dev = torch.device(args.dist_device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    rank = args.tp_rank
    tdist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                             f"{args.dist_port}", world_size=args.dist_world,
                             rank=rank)
    ref = torch.load(work / "tp_ref.pt")
    greedy = dist_params("greedy", TP_B, dev)
    out = {}

    def rows_clone(cache, B):
        r0, n = dist.rows(B, dist.get_ctx().batch_axes)
        c = {k: v.clone() for k, v in cache.items()}
        if c["len"].shape[0] != n:
            c["len"] = c["len"][r0:r0 + n]
        return c

    def whole(cache, specs):
        for k, spec in specs.items():
            for d, e in enumerate(spec):
                if e is not None:
                    cache[k] = dist.all_gather(cache[k], e, dim=d, tiled=True)
        return cache

    for arch, layers, meshes, algos, n_steps, dtype in TP_RUNS:
        cfg = tp_config(arch, layers, dtype)
        model = Model(cfg)
        R = ref[arch]
        prompts, want_l, want_t = (R["prompts"].to(dev), R["logits"],
                                   R["tokens"])
        full = model.init(seed=0, device=dev)
        for shape in meshes:
            mesh = make_local_mesh(*shape)
            t = shape[1]
            for algo in algos:
                tag = f"{arch}_{shape[0]}x{shape[1]}_{algo}"
                pre, dec = tp_programs(cfg, mesh, algo, dev)
                torch.cuda.reset_peak_memory_stats(dev)
                with dist.use_mesh(mesh, batch_axes=pre[4]), \
                        torch.no_grad():
                    r0, n = dist.rows(TP_B, ("data",))
                    V = cfg.vocab_size
                    cols = V // t if V % t == 0 else V
                    c0 = dist.axis_index("model") * cols if cols != V else 0
                    zeros = {k: torch.zeros(v.shape, dtype=v.dtype,
                                            device=dev)
                             for k, v in pre[1][2].items()}
                    p, b, c, s_ = steps.local_inputs(
                        cfg, (full, {"tokens": prompts}, zeros, greedy),
                        pre[2], mesh)
                    lg, _ = model.prefill(p, b, rows_clone(c, TP_B))
                    errs = [float((lg.float().cpu() - want_l[0][
                        r0:r0 + n, c0:c0 + cols]).abs().max())]
                    finite = bool(torch.isfinite(lg).all())
                    tok, c = pre[0](p, b, c, s_)
                    diffs = []

                    def held(got, s):
                        w = want_t[s][r0:r0 + n]
                        for i in (got.cpu() != w).nonzero().flatten().tolist():
                            top = want_l[s][r0 + i].topk(2).values
                            diffs.append({"step": s, "row": r0 + i, "gap":
                                          float(top[0] - top[1])})
                    held(tok, 0)
                    st = pen.update_histograms(pen.init_state(
                        TP_B, V, prompts), want_t[0].to(dev))
                    _, c, st, _, s_, _ = steps.local_inputs(
                        cfg, (None, pad_cache(whole(c, pre[2][2]), TP_CACHE),
                              st, None, greedy, 0), dec[2], mesh)
                    w_held = sharding.held_bytes(p)
                    w_spec = sharding.rank_bytes(dec[1][0], dec[2][0], mesh)
                    w_whole = sharding.held_bytes(full)
                    c_held = sharding.held_bytes(c)
                    c_spec = sharding.rank_bytes(dec[1][1], dec[2][1], mesh)
                    ms, coll_ms, calls, launches = [], [], {}, {}
                    ops.reset_launch_counts()
                    for s in range(n_steps):
                        tok_in = want_t[s][r0:r0 + n].to(dev)
                        before = rows_clone(c, TP_B)
                        sync(dev)
                        dist.reset_collective_stats()
                        dist.set_timing(True)
                        t0 = time.perf_counter()
                        tok, c, st = dec[0](p, c, st, tok_in, s_, s + 1)
                        sync(dev)
                        ms.append((time.perf_counter() - t0) * 1e3)
                        dist.set_timing(False)
                        cs = dist.collective_stats()
                        coll_ms.append(1e3 * sum(v["seconds"]
                                                 for v in cs.values()))
                        for k, v in cs.items():
                            acc = calls.setdefault(k, {"calls": 0,
                                                       "bytes": 0})
                            acc["calls"] += v["calls"]
                            acc["bytes"] += v["bytes"]
                        held(tok, s + 1)
                        lg, _ = model.decode_step(p, tok_in, before)
                        errs.append(float((lg.float().cpu() - want_l[s + 1][
                            r0:r0 + n, c0:c0 + cols]).abs().max()))
                        finite &= bool(torch.isfinite(lg).all())
                    launches = ops.launch_counts()
                    # bytes a rank would receive over NVLink, each
                    # collective counted over a group of t (the model
                    # axis'; the (2, 2) mesh's batch gathers are smaller)
                    cstats = ha.collective_stats_from(
                        calls, {k: t for k in calls})
                    bound_rank, bound_card = tp_bound(cfg, t)
                    med = sorted(ms)[len(ms) // 2]
                    rec = {
                        "ok": finite and all(d["gap"] < GAP_CLEAR
                                             for d in diffs) and all(
                            launches.get(k, 0) > 0 for k in TP_KERNELS[algo]),
                        "logits_block": list(lg.shape),
                        "max_abs_err": max(errs), "token_diffs": diffs,
                        "weight_bytes": w_held, "weight_bytes_spec": w_spec,
                        "weight_bytes_whole": w_whole,
                        "cache_bytes": c_held, "cache_bytes_spec": c_spec,
                        "max_memory_allocated": torch.cuda.max_memory_allocated(
                            dev),
                        "step_ms": ms, "step_ms_median": med,
                        "collective_ms_median": sorted(coll_ms)[
                            len(coll_ms) // 2],
                        "collective_calls_a_step": {
                            k: v["calls"] / n_steps for k, v in calls.items()},
                        "collectives_a_step": sum(
                            v["calls"] for v in calls.values()) / n_steps,
                        "collective_bytes_a_step": cstats.total_bytes /
                        n_steps,
                        "nvlink_ms_reckoned": 1e3 * cstats.total_bytes /
                        n_steps / ha.NVLINK_BW,
                        "launches": launches,
                        "bound_ms_card_a_rank": bound_rank,
                        "bound_ms_one_card": bound_card}
                out[tag] = {rank: rec}
                print(f"{tag}: logits block {rec['logits_block']}, max abs "
                      f"err {rec['max_abs_err']:.4g}, token diffs {diffs}, "
                      f"weights {w_held} B (spec {w_spec}, whole {w_whole}), "
                      f"cache {c_held} B (spec {c_spec}), peak "
                      f"{rec['max_memory_allocated']} B, step "
                      f"{med:.1f} ms, collectives "
                      f"{rec['collectives_a_step']:.0f} a step in "
                      f"{rec['collective_ms_median']:.1f} ms, launches "
                      f"{launches}, ok {rec['ok']}", flush=True)
        del full
        torch.cuda.empty_cache()
    out["staged"] = list(dist.staged_collectives())
    gathered = [None] * args.dist_world
    tdist.all_gather_object(gathered, out)
    if rank == 0:
        merged = {"staged": sorted({s for o in gathered for s in o["staged"]})}
        for o in gathered:
            for tag, per in o.items():
                if tag != "staged":
                    merged.setdefault(tag, {}).update(
                        {str(k): v for k, v in per.items()})
        (work / "tp_ranks.json").write_text(json.dumps(merged))
    tdist.barrier()
    tdist.destroy_process_group()
    return 0


def tp_phase(dev, card):
    """Phase 12: (a) the one-rank NCCL mesh; (b), (c) the four gloo ranks
    on this card, each rank's blocks held to the single-process model."""
    import shutil
    import tempfile
    t0 = time.perf_counter()
    out = {"one_rank_nccl": tp_one_rank(dev, card)}
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_tp_"))
    try:
        tp_reference(dev, work)
        ranks = tp_four_ranks(dev, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for arch, layers, meshes, algos, n_steps, dtype in TP_RUNS:
        for shape in meshes:
            for algo in algos:
                tag = f"{arch}_{shape[0]}x{shape[1]}_{algo}"
                per = ranks[tag]
                assert len(per) == 4, (tag, sorted(per))
                for r, rec in sorted(per.items()):
                    assert rec["ok"], (tag, r, rec)
                    assert rec["weight_bytes"] == rec["weight_bytes_spec"], \
                        (tag, r)
                    assert rec["cache_bytes"] <= rec["cache_bytes_spec"], \
                        (tag, r)
                r0 = per["0"]
                depth = f"{layers} of {tp_config(arch, None).num_layers} " \
                    "layers" if layers else "full depth"
                print(
                    f"phase 12 ({'b' if arch == 'smollm-360m' else 'c'}) "
                    f"{tag} ({depth}, {dtype}, B = {TP_B}, prompt "
                    f"{TP_PROMPT}, cache "
                    f"{TP_CACHE}, {n_steps} serve steps): per rank max abs "
                    f"logits err "
                    f"{[round(per[str(r)]['max_abs_err'], 4) for r in range(4)]}"
                    f", greedy tokens equal but for "
                    f"{sum(len(per[str(r)]['token_diffs']) for r in range(4))}"
                    f" (rank, step, row) places, each under the gap "
                    f"{GAP_CLEAR}; weight bytes a rank "
                    f"{[per[str(r)]['weight_bytes'] for r in range(4)]} = the "
                    f"spec's (whole {r0['weight_bytes_whole']}), cache bytes "
                    f"{[per[str(r)]['cache_bytes'] for r in range(4)]} <= the "
                    f"spec's {r0['cache_bytes_spec']}; max memory allocated "
                    f"{[per[str(r)]['max_memory_allocated'] for r in range(4)]}"
                    f" B; step median "
                    f"{[round(per[str(r)]['step_ms_median'], 1) for r in range(4)]}"
                    f" ms, of it collectives "
                    f"{[round(per[str(r)]['collective_ms_median'], 1) for r in range(4)]}"
                    f" ms, {r0['collectives_a_step']:.0f} collectives a step "
                    f"{r0['collective_calls_a_step']}; launches a rank "
                    f"{[per[str(r)]['launches'] for r in range(4)]}; analytic "
                    f"bound (hlo_analysis, H100 SXM5 constants) "
                    f"{r0['bound_ms_card_a_rank']:.4f} ms with a card a rank, "
                    f"{r0['bound_ms_one_card']:.4f} ms for the four ranks' "
                    f"work on this one card; the collectives' "
                    f"{r0['collective_bytes_a_step']:.0f} B a rank a step "
                    f"would take {r0['nvlink_ms_reckoned']:.4f} ms at "
                    f"NVLink's rate (reckoned, not measured) [{card}]")
    out["four_ranks"] = ranks
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 12 took {out['seconds']:.1f} s")
    return out


def tp_only(dev, card):
    """``--tp-only``: phase 12 alone; prints one JSON line."""
    print(json.dumps({"tp_only": {"card": card, "runs": tp_phase(dev, card)}}))
    return 0


# ---------------------------------------------------------------------------
# phase 13: the train-step program under a mesh (the collectives' adjoints,
# the vocab-parallel loss, the norm over the blocks), the dry-run's trace
# on fake CUDA tensors, and the examples
# ---------------------------------------------------------------------------
MT_B, MT_S, MT_STEPS = 8, 128, 3         # phase 10 (a)'s batch, 3 steps
# (arch, layers or None, meshes): smollm-360m at full width and depth on
# both meshes; granite (8 of 24 layers) at (1, 4) through the EP MoE
MT_RUNS = (("smollm-360m", None, ((1, 4), (2, 2))),
           ("granite-moe-1b-a400m", 8, ((1, 4),)))
# the train step's tolerances in bf16 against the single process on this
# card: the loss (an f32 mean over 1,024 tokens) and the grad norm
# relative; the parameter blocks after step 1 within 2·lr plus one bf16
# rounding of the parameter (the first AdamW step moves an element by ±lr
# by its gradient's sign: a gradient that bf16's partial sums in another
# order leave near 0 may flip it, 2·lr, and the bf16 result rounds by up
# to 2^-8 of itself either way)
MT_LOSS_RTOL, MT_NORM_RTOL = 1e-3, 1e-2
# the dry-run's combinations on 16×16 ((arch, shape, multi-pod)); the
# fourth shape, prefill_32k, is left out: its trace runs ~1.3 M ops of
# attend_chunked at S = 32768 (see ROADMAP)
MT_DRYRUN = (("smollm-360m", "train_4k", False),
             ("smollm-360m", "decode_32k", False),
             ("smollm-360m", "long_500k", False),
             ("smollm-360m", "decode_32k", True),
             ("granite-moe-1b-a400m", "train_4k", False),
             ("rwkv6-3b", "decode_32k", False))
# each example at small arguments (the train example's checkpoint goes to
# the phase's temporary directory; 20 steps, so that its warmup moves the
# loss down, which the example asserts)
MT_EXAMPLES = (("torch_quickstart", [], "fast-path acceptance="),
               ("torch_serve_continuous_batching",
                ["--requests", "4", "--max-new", "4"], "shvs"),
               ("torch_autotune_serving", ["--requests", "4",
                                           "--max-new", "16"],
                "served 4 requests"),
               ("torch_shvs_sizing", ["--iters", "2"],
                "H* (first-order condition)"),
               ("torch_train_100m", ["--steps", "20", "--batch", "2",
                                     "--seq-len", "32"],
                "checkpoint round-trip ok at step 20"))


def mt_batches(cfg):
    """MT_STEPS seeded batches of tokens and labels (B = 8, S = 128)."""
    import numpy as np
    import torch
    rs = np.random.default_rng(13)
    return [{k: torch.from_numpy(rs.integers(0, cfg.vocab_size, (
        MT_B, MT_S)).astype(np.int32)) for k in ("tokens", "labels")}
        for _ in range(MT_STEPS)]


def mt_program(cfg, mesh, dev):
    from repro_torch.config import ShapeConfig
    from repro_torch.launch import steps
    return steps.make_train_step_program(
        cfg, ShapeConfig("mt_train", MT_S, MT_B, "train"), mesh, device=dev)


def mt_one_rank(dev, card):
    """Phase 13 (a): one step of the train program of full-width
    smollm-360m (B = 8, S = 128) under a (1, 1) NCCL mesh equals the
    program without a mesh bit for bit: loss, grad norm, and every
    parameter and AdamW moment after the step."""
    import socket
    import torch
    import torch.distributed as tdist
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import dist
    from repro_torch.models.model import Model
    from repro_torch.training.optimizer import adamw_init
    cfg = tp_config("smollm-360m", None)
    full = Model(cfg).init(seed=0, device=dev)
    batch = to_dev(mt_batches(cfg)[0], dev)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    tdist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                             world_size=1, rank=0, device_id=dev)

    def run(mesh):
        fn, _, ins, _, baxes = mt_program(cfg, mesh, dev)
        with dist.use_mesh(mesh, batch_axes=baxes):
            p, _, b = steps.local_inputs(cfg, (full, None, batch), ins, mesh)
            q, opt, met = fn(p, adamw_init(p), b)
            sync(dev)
        return q, opt, {k: float(v) for k, v in met.items()}
    try:
        want = run(None)
        got = run(make_local_mesh(1, 1))
    finally:
        tdist.destroy_process_group()
    assert got[2] == want[2], (got[2], want[2])
    assert leaves_equal(got[0], want[0]) and leaves_equal(got[1], want[1])
    print(f"phase 13 (a) (1, 1) NCCL mesh: smollm-360m's train program (B "
          f"= {MT_B}, S = {MT_S}) equals the program without a mesh bit for "
          f"bit: loss {got[2]['loss']:.6f}, grad norm "
          f"{got[2]['grad_norm']:.6f}, every parameter and moment after the "
          f"step [{card}]")
    return {"equal": True, "loss": got[2]["loss"],
            "grad_norm": got[2]["grad_norm"]}


def mt_reference(dev, work):
    """The single-process side of phase 13 (b): for each run, MT_STEPS
    train-program steps of the unsplit model on this card from the seeded
    init: each step's loss and grad norm, and the parameters after step 1
    (on the host), written to ``work`` for the ranks."""
    import torch
    from repro_torch.models.model import Model
    from repro_torch.training.optimizer import adamw_init
    out = {}
    for arch, layers, _ in MT_RUNS:
        cfg = tp_config(arch, layers)
        fn = mt_program(cfg, None, dev)[0]
        p = Model(cfg).init(seed=0, device=dev)
        opt = adamw_init(p)
        mets, after1 = [], None
        torch.cuda.reset_peak_memory_stats(dev)
        ms = []
        for i, b in enumerate(mt_batches(cfg)):
            sync(dev)
            t0 = time.perf_counter()
            p, opt, met = fn(p, opt, to_dev(b, dev))
            sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            mets.append({k: float(v) for k, v in met.items()})
            if i == 0:
                after1 = {k: v.cpu() for k, v in _leaves_by_path(p).items()}
        out[arch] = {"metrics": mets, "after1": after1, "step_ms": ms,
                     "peak": torch.cuda.max_memory_allocated(dev)}
        del p, opt
        torch.cuda.empty_cache()
    torch.save(out, work / "mt_ref.pt")
    return {a: {"metrics": r["metrics"], "step_ms": r["step_ms"],
                "peak": r["peak"]} for a, r in out.items()}


def _leaves_by_path(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_leaves_by_path(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = v
    return out


def mt_rank_main(args):
    """One of phase 13's four ranks: each run of MT_RUNS on its meshes,
    MT_STEPS steps of the train program on the rank's blocks, timed, its
    collectives timed and counted by phase; rank 0 writes
    ``mt_ranks.json``."""
    import math
    import torch
    import torch.distributed as tdist
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding, steps
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import dist
    from repro_torch.models.model import Model
    from repro_torch.training.optimizer import adamw_init
    work = Path(args.dist_dir)
    dev = torch.device(args.dist_device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    rank = args.mt_rank
    tdist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                             f"{args.dist_port}", world_size=args.dist_world,
                             rank=rank)
    ref = torch.load(work / "mt_ref.pt")
    out = {}
    for arch, layers, meshes in MT_RUNS:
        cfg = tp_config(arch, layers)
        R = ref[arch]
        full = Model(cfg).init(seed=0, device=dev)
        batches = mt_batches(cfg)
        for shape in meshes:
            mesh = make_local_mesh(*shape)
            tag = f"{arch}_{shape[0]}x{shape[1]}"
            fn, a_in, ins, _, baxes = mt_program(cfg, mesh, dev)
            torch.cuda.reset_peak_memory_stats(dev)
            recs, phases = [], {}
            ops.reset_launch_counts()
            with dist.use_mesh(mesh, batch_axes=baxes):
                p, _, _ = steps.local_inputs(cfg, (full, None, None), ins,
                                             mesh)
                opt = adamw_init(p)
                for i, b in enumerate(batches):
                    _, _, bl = steps.local_inputs(
                        cfg, (None, None, to_dev(b, dev)), ins, mesh)
                    sync(dev)
                    dist.reset_collective_stats()
                    dist.set_timing(True)
                    t0 = time.perf_counter()
                    p, opt, met = fn(p, opt, bl)
                    sync(dev)
                    ms = (time.perf_counter() - t0) * 1e3
                    dist.set_timing(False)
                    for ph, st in dist.phase_stats().items():
                        acc = phases.setdefault(ph, {"calls": 0,
                                                     "seconds": 0.0})
                        acc["calls"] += sum(v["calls"] for v in st.values())
                        acc["seconds"] += sum(v["seconds"]
                                              for v in st.values())
                    want = R["metrics"][i]
                    rel = lambda k: abs(float(met[k]) - want[k]) / \
                        abs(want[k])
                    recs.append({"ms": ms, "loss": float(met["loss"]),
                                 "grad_norm": float(met["grad_norm"]),
                                 "loss_rel_err": rel("loss"),
                                 "grad_norm_rel_err": rel("grad_norm")})
                    if i == 0:
                        lr = float(met["lr"])
                        specs = _leaves_by_path(ins[0])
                        p_err, p_off = 0.0, 0
                        for k, mine in _leaves_by_path(p).items():
                            blk = sharding.local_shard(
                                R["after1"][k], specs[k], mesh).to(dev)
                            d = (mine.float() - blk.float()).abs()
                            p_err = max(p_err, float(d.max()) / lr)
                            # beyond 2·lr plus one bf16 rounding of each
                            p_off += int((d > 2 * lr + 2 ** -7 *
                                          blk.float().abs()).sum())
                w_held = sharding.held_bytes(p)
                w_spec = sharding.rank_bytes(a_in[0], ins[0], mesh)
                m_held = sharding.held_bytes({"mu": opt.mu, "nu": opt.nu})
                m_spec = sharding.rank_bytes(
                    {"mu": a_in[1].mu, "nu": a_in[1].nu},
                    {"mu": ins[1].mu, "nu": ins[1].nu}, mesh)
            finite = all(math.isfinite(r["loss"]) and
                         math.isfinite(r["grad_norm"]) for r in recs)
            rec = {
                "ok": finite and p_off == 0 and w_held == w_spec and
                m_held == m_spec and
                all(r["loss_rel_err"] <= MT_LOSS_RTOL and
                    r["grad_norm_rel_err"] <= MT_NORM_RTOL for r in recs),
                "steps": recs, "params_max_err_over_lr": p_err,
                "params_off": p_off, "weight_bytes": w_held,
                "weight_bytes_spec": w_spec, "moment_bytes": m_held,
                "moment_bytes_spec": m_spec,
                "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
                "collectives_a_step": {
                    ph: {"calls": v["calls"] / MT_STEPS,
                         "ms": 1e3 * v["seconds"] / MT_STEPS}
                    for ph, v in phases.items()},
                "launches": ops.launch_counts()}
            out[tag] = {rank: rec}
            print(f"{tag}: steps {[round(r['ms'], 1) for r in recs]} ms, "
                  f"loss err {[r['loss_rel_err'] for r in recs]}, grad norm "
                  f"err {[r['grad_norm_rel_err'] for r in recs]}, params "
                  f"after step 1 max err {p_err:.3f} lr ({p_off} off), "
                  f"weights {w_held} B (spec {w_spec}), moments {m_held} B "
                  f"(spec {m_spec}), peak {rec['max_memory_allocated']} B, "
                  f"collectives a step {rec['collectives_a_step']}, ok "
                  f"{rec['ok']}", flush=True)
        del full
        torch.cuda.empty_cache()
    out["staged"] = list(dist.staged_collectives())
    gathered = [None] * args.dist_world
    tdist.all_gather_object(gathered, out)
    if rank == 0:
        merged = {"staged": sorted({s for o in gathered for s in o["staged"]})}
        for o in gathered:
            for tag, per in o.items():
                if tag != "staged":
                    merged.setdefault(tag, {}).update(
                        {str(k): v for k, v in per.items()})
        (work / "mt_ranks.json").write_text(json.dumps(merged))
    tdist.barrier()
    tdist.destroy_process_group()
    return 0


def mt_four_ranks(dev, work):
    """Phase 13 (b): four ranks spawned on this card over gloo."""
    import os
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "2"
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--mt-rank", str(r),
         "--dist-world", "4", "--dist-port", str(port), "--dist-dir",
         str(work), "--dist-device", str(dev)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    logdir = ROOT / "chiprun_out"
    logdir.mkdir(exist_ok=True)
    for r, (p, log) in enumerate(zip(procs, logs)):
        (logdir / f"mt_rank{r}.log").write_text(log)
        if p.returncode != 0:
            print(log[-6000:])
        assert p.returncode == 0, f"rank {r} exited with {p.returncode}"
    return json.loads((work / "mt_ranks.json").read_text())


def mt_dryrun_start(work, device="cuda"):
    """Phase 13 (c): ``python -m repro_torch.launch.dryrun --device cuda``
    once for each of MT_DRYRUN, side by side, at the lowest CPU priority
    (``nice`` 19: the traces are host work on fake tensors, run on the
    cores (a) and (b) leave idle); returns the processes."""
    import os
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["OMP_NUM_THREADS"] = "1"
    procs = []
    for i, (arch, shape, multi) in enumerate(MT_DRYRUN):
        log = open(work / f"dryrun_{i}.log", "w")
        procs.append((log, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", "multi" if multi else
             "single", "--device", device, "--out",
             str(work / f"dryrun_{i}.jsonl")], env=env, cwd=str(ROOT),
            stdout=log, stderr=subprocess.STDOUT,
            preexec_fn=lambda: os.nice(19))))
    return procs


def mt_dryrun_finish(procs, work, card, device="cuda"):
    """Wait for the dry-runs; every record ``ok`` and traced on
    ``device``."""
    recs = []
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    for i, (log, p) in enumerate(procs):
        try:
            rc = p.wait(timeout=900)
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
        text = (work / f"dryrun_{i}.log").read_text()
        (ROOT / "chiprun_out" / f"mt_dryrun_{i}.log").write_text(text)
        if rc != 0 or "dry-run complete: 1/1 ok" not in text:
            print(text[-6000:])
        assert rc == 0, (MT_DRYRUN[i], rc)
        rec = json.loads((work / f"dryrun_{i}.jsonl").read_text()
                         .splitlines()[-1])
        assert rec["status"] == "ok" and rec["device"] == device, rec
        recs.append(rec)
        print(f"phase 13 (c) dry-run {rec['arch']} {rec['shape']} "
              f"{rec['mesh']} on fake CUDA tensors: ok, traced in "
              f"{rec['lower_s']:.1f} s ({rec['traced_ops']} ops), dot FLOPs "
              f"· chips {rec['parsed_dot_flops']:.3e} against model FLOPs "
              f"{rec['model_flops']:.3e}, collectives "
              f"{rec['collective_counts']}, bytes a device "
              f"{rec['bytes_per_device']:.3e}, bottleneck "
              f"{rec['bottleneck']} [{card}]")
    return recs


def mt_kernel_paths(card):
    """Phase 13 (c), the kernels' real path after the dry-run's: a fake
    CUDA tensor launches nothing, a real one launches each kernel once
    (``ops.launch_counts`` rises by one each)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.core.sampling import SamplingParams
    from repro_torch.kernels import ops
    B, V = 4, 4096
    dev = torch.device("cuda", 0)

    def call_all():
        # greedy-free unfiltered rows, no penalties: inside every kernel's
        # contract (top_p in (0, 1], min_p in [0, 1))
        full = lambda shape, v, dt=torch.float32: torch.full(
            shape, v, dtype=dt, device=dev)
        z = torch.arange(B * V, dtype=torch.float32, device=dev).reshape(
            B, V).remainder(97.0) / 10.0
        c = full((B, V), 0, torch.int32)
        hot = torch.arange(V, device=dev) < 256
        one, zero = full((B,), 1.0), full((B,), 0.0)
        ops.fused_penalty_scale(z, c, c, one, zero, zero, one)
        ops.fused_shvs_masses(z, hot)
        ops.fused_sample(z, c, c, SamplingParams(
            one, full((B,), 0, torch.int32), one, zero, one, zero, zero),
            full((B,), 0.5), hot, k_cap=64)
        ops.fused_gumbel_argmax(z, 7)
    ops.reset_launch_counts()
    with FakeTensorMode():
        call_all()
    fake = ops.launch_counts()
    call_all()
    sync(dev)
    real = ops.launch_counts()
    assert all(v == 0 for v in fake.values()), fake
    assert all(v == 1 for v in real.values()), real
    print(f"phase 13 (c) fake CUDA tensors launch nothing ({fake}); real "
          f"ones launch each kernel once ({real}) [{card}]")
    return {"fake_launches": fake, "real_launches": real}


def mt_examples(work, card, device="cuda"):
    """Phase 13 (d): each ``examples/torch_*.py`` on the card, in this
    process, at its smallest arguments, the launch counters set to 0 just
    before each and read just after."""
    import contextlib as cl
    import importlib.util
    import io
    import torch
    from repro_torch.kernels import ops
    out = {}
    for name, args, expect in MT_EXAMPLES:
        if name == "torch_train_100m":
            args = args + ["--ckpt", str(work / "ckpt_100m")]
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        buf = io.StringIO()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with cl.redirect_stdout(buf):
            mod.main(["--device", device, *args])
        sync(torch.device(device))
        dt = time.perf_counter() - t0
        text = buf.getvalue()
        assert expect in text, (name, text[-2000:])
        out[name] = {"seconds": dt, "launches": ops.launch_counts(),
                     "last_line": text.strip().splitlines()[-1]}
        print(f"phase 13 (d) examples/{name}.py {' '.join(args)} on the "
              f"card: {dt:.1f} s, launches {out[name]['launches']}; "
              f"\"{out[name]['last_line']}\" [{card}]")
        torch.cuda.empty_cache()
    return out


def mesh_train_phase(dev, card):
    """Phase 13: (c) the dry-runs on fake CUDA tensors, started first at
    the lowest CPU priority and run beside (a) the one-rank NCCL train
    program, (b) four gloo ranks on this card, each rank's step held to
    the single process's, and (d) the examples on the card."""
    import shutil
    import tempfile
    t0 = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_mt_"))
    procs = mt_dryrun_start(work)
    try:
        out = {"one_rank_nccl": mt_one_rank(dev, card)}
        out["single_process"] = mt_reference(dev, work)
        ranks = mt_four_ranks(dev, work)
        out["examples"] = mt_examples(work, card)
        t_c = time.perf_counter()
        out["dryrun"] = mt_dryrun_finish(procs, work, card)
        out["dryrun_wait_s"] = time.perf_counter() - t_c
        out["kernel_paths"] = mt_kernel_paths(card)
    finally:
        for log, p in procs:          # stopped where a step above failed
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
        shutil.rmtree(work, ignore_errors=True)
    for arch, layers, meshes in MT_RUNS:
        sp = out["single_process"][arch]
        for shape in meshes:
            tag = f"{arch}_{shape[0]}x{shape[1]}"
            per = ranks[tag]
            assert len(per) == 4, (tag, sorted(per))
            for r, rec in sorted(per.items()):
                assert rec["ok"], (tag, r, rec)
            r0 = per["0"]
            depth = f"{layers} of {tp_config(arch, None).num_layers} " \
                "layers" if layers else "full depth"
            col = lambda f: [f(per[str(r)]) for r in range(4)]
            print(
                f"phase 13 (b) {tag} ({depth}, bf16, B = {MT_B}, S = "
                f"{MT_S}, {MT_STEPS} steps from one init and the same "
                f"batches; single process on this card: losses "
                f"{[round(m['loss'], 4) for m in sp['metrics']]}, grad norms "
                f"{[round(m['grad_norm'], 4) for m in sp['metrics']]}, step "
                f"{[round(x, 1) for x in sp['step_ms']]} ms): per rank loss "
                f"rel err max "
                f"{col(lambda x: max(s['loss_rel_err'] for s in x['steps']))}"
                f", grad norm rel err max "
                f"{col(lambda x: max(s['grad_norm_rel_err'] for s in x['steps']))}"
                f", parameter blocks after step 1 within "
                f"{col(lambda x: round(x['params_max_err_over_lr'], 3))} lr; "
                f"weight bytes {col(lambda x: x['weight_bytes'])} = the "
                f"spec's, AdamW moment bytes "
                f"{col(lambda x: x['moment_bytes'])} = the spec's; step ms "
                f"{col(lambda x: [round(s['ms'], 1) for s in x['steps']])}; "
                f"collectives a step (calls, ms) "
                f"{ {ph: (v['calls'], round(v['ms'], 1)) for ph, v in r0['collectives_a_step'].items()} }"
                f" (rank 0); peak "
                f"{col(lambda x: x['max_memory_allocated'])} B [{card}]")
    out["four_ranks"] = ranks
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 13 took {out['seconds']:.1f} s (of it "
          f"{out['dryrun_wait_s']:.1f} s waiting for (c)'s dry-runs after "
          f"(a), (b) and (d))")
    return out


def mesh_train_only(dev, card):
    """``--mesh-train-only``: phase 13 alone; prints one JSON line."""
    print(json.dumps({"mesh_train_only": {
        "card": card, "runs": mesh_train_phase(dev, card)}}))
    return 0


# -- phase 14: degenerate decision rows ----------------------------------------

DEGENERATE_SHAPES = (("main", B_MAIN, V_MAIN), ("large", B_LARGE, V_LARGE),
                     ("odd", B_MAIN, V_ODD))
DEGENERATE_K = (K_CAP, 2048)
DEGENERATE_NEW = 16
# (prompt, the request's filters over synth_requests' sampling; None: as
# drawn) of phase 14's batch; a degenerate request is followed by its
# greedy twin (the same prompt and penalties, greedy=True)
DEGENERATE_BATCH = ((0, dict(top_p=0.0)), (1, dict(min_p=2.0)),
                    (2, dict(top_k=0, top_p=0.0)), (3, None), (1, None))


def degenerate_fixture():
    """``tests/torch_degenerate_rows.py``, the rows the CPU tests hold to
    the reference."""
    sys.path.insert(0, str(ROOT / "tests"))
    import torch_degenerate_rows
    return torch_degenerate_rows


def degenerate_kernels(dev):
    """Phase 14 (a): every kernel against its plain version on every case
    of the fixture at the main, the large and the odd shape, and on the
    probe that first showed the out-of-bounds draw (ROADMAP Fault 10).
    Returns the per-row report and the checks that differ."""
    import torch
    from repro_torch.kernels import fused_kernel
    fx = degenerate_fixture()
    report, bad = {}, []
    for shape, B, V in DEGENERATE_SHAPES:
        for name in fx.CASES:
            res = fx.kernel_rows(fx.tensors(fx.case(name, B, V, seed=B + V),
                                            dev),
                                 k_caps=DEGENERATE_K, block_v=BLOCK_V)
            differ = res.pop("differ")
            report[f"{shape} {name}"] = {"B": B, "V": V, "rows": res,
                                         "differ": differ}
            bad += [f"{shape} {name}: {k} rows {v['rows']}"
                    for k, v in differ.items()]
            said = "; ".join(f"{k} differs at rows {v['rows']}"
                             for k, v in differ.items()) or \
                f"{len(res)} checks equal on all {B} rows"
            print(f"degenerate {shape} B={B} V={V} {name}: {said}")
    x = fx.probe_inputs(dev)
    res = fx.kernel_rows(x, k_caps=(64,), block_v=BLOCK_V)
    tokens, _, _, kept = fused_kernel.fused_sample(
        *[x[k] for k in fx.FUSED], k_cap=64, block_v=BLOCK_V)
    torch.cuda.synchronize()
    probe = {"rows": {k: v for k, v in res.items() if k != "differ"},
             "differ": res["differ"], "tokens": tokens.tolist(),
             "argmax": x["logits"].argmax(-1).tolist(),
             "kept": kept.tolist()}
    report["probe B=3 V=1000 min_p=2"] = probe
    bad += [f"probe: {k} rows {v['rows']}" for k, v in res["differ"].items()]
    if probe["tokens"] != probe["argmax"] or any(probe["kept"]):
        bad.append(f"probe: tokens {probe['tokens']} kept {probe['kept']}, "
                   f"not the argmax {probe['argmax']} with nothing kept")
    print(f"degenerate probe B=3 V=1000 k_cap 64 min_p=2: tokens "
          f"{probe['tokens']} (argmax {probe['argmax']}), kept "
          f"{probe['kept']}, {len(probe['rows'])} checks "
          f"{'equal' if not res['differ'] else 'differ'}")
    return report, bad


def degenerate_batch(V):
    """Phase 14's batch: ``DEGENERATE_BATCH`` over synth_requests' prompts
    and sampling, each degenerate request followed by its greedy twin;
    returns the requests and the (degenerate, twin) index pairs."""
    import dataclasses
    from repro_torch.launch.serve import synth_requests
    base = synth_requests(4, V, DEGENERATE_NEW, seed=0)
    reqs, pairs = [], []
    for prompt, filters in DEGENERATE_BATCH:
        r = copy.deepcopy(base[prompt])
        if filters is not None:
            r.sampling = dataclasses.replace(r.sampling, **filters)
            twin = copy.deepcopy(base[prompt])
            twin.sampling = dataclasses.replace(twin.sampling, greedy=True)
            pairs.append((len(reqs), len(reqs) + 1))
            reqs += [r, twin]
        else:
            reqs.append(r)
    for i, r in enumerate(reqs):
        r.request_id = i
    return reqs, pairs


def degenerate_streams(dev, card):
    """Phase 14 (b), (c): full-width smollm-360m with ``fused`` on the
    contiguous and the paged cache (a pool that holds the batch, so no
    request is preempted and twins compute alike) serves a batch of 8
    mixing ``top_p = 0`` and ``min_p = 2`` requests with their greedy twins
    and ordinary ones; where nothing is kept the draw is the top penalised
    logit, so each degenerate stream must equal its twin's. The engine then
    serves a later batch on the same CUDA context. (c) the gateway over one
    such replica: ``"top_p": 0`` and ``"min_p": 2`` requests get 200 and
    their greedy twin's stream."""
    import torch
    from repro_torch.gateway import ReplicaFleet
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_batch, synth_requests
    V, out, params = V_MAIN, {}, None
    for cache, kw in (("contiguous", {}),
                      ("paged", dict(cache="paged", block_size=16))):
        eng = engine("fused", dev, params=params, **kw)
        params = eng.params
        serve_batch(eng, synth_requests(2, V, 2, rng_seed=99, seed=0))
        reqs, pairs = degenerate_batch(V)
        ops.reset_launch_counts()
        rep = serve_batch(eng, reqs)
        counts = ops.launch_counts()
        for r in reqs:
            assert r.finish_reason == "length" and \
                len(r.output) == DEGENERATE_NEW, \
                (cache, r.request_id, r.finish_reason, len(r.output))
        twins = [{"request": a, "sampling": {
            k: getattr(reqs[a].sampling, k) for k in ("top_k", "top_p",
                                                      "min_p")},
            "equal": reqs[a].output == reqs[b].output,
            "tokens": reqs[a].output, "twin": reqs[b].output}
            for a, b in pairs]
        later = synth_requests(8, V, 4, rng_seed=5, seed=1)
        serve_batch(eng, later)
        torch.cuda.synchronize()
        assert all(r.finish_reason == "length" and len(r.output) == 4
                   for r in later), "the later batch did not finish"
        eng.close()
        out[cache] = {"report": rep, "launches": counts, "twins": twins,
                      "later_batch": "served"}
        for t in twins:
            print(f"degenerate {cache}: request {t['request']} "
                  f"{t['sampling']} stream {'==' if t['equal'] else '!='} "
                  f"its greedy twin's ({len(t['tokens'])} tokens)")
        print(f"degenerate {cache}: {rep['requests']} requests, TPOT p50 "
              f"{rep['tpot_p50_ms']:.2f} ms, launches {counts}; a later "
              f"batch of 8 served on the same context [{card}]")
        assert counts["fused_sample"] > 0, counts
        assert all(t["equal"] for t in twins), \
            f"{cache}: a degenerate stream differs from its greedy twin's"

    fleet = ReplicaFleet([engine("fused", dev, params=params)], capacity=4)
    common = {"prompt": GATEWAY_PROMPTS[0], "max_tokens": 8,
              "temperature": 0.8, "repetition_penalty": 1.1, "seed": 5}
    payloads = [dict(common, top_p=0), dict(common, min_p=2),
                dict(common, greedy=True)]
    results, _, _ = gateway_run(fleet, GATEWAY_PROMPTS, payloads, warm=1)
    out["gateway"] = [{"payload": {k: v for k, v in p.items()
                                   if k in ("top_p", "min_p", "greedy")},
                       "status": r.status, "tokens": r.tokens}
                      for p, r in zip(payloads, results)]
    for g in out["gateway"]:
        print(f"degenerate gateway {g['payload']}: HTTP {g['status']}, "
              f"tokens {g['tokens']}")
    assert all(r.status == 200 and r.error is None for r in results), \
        [(r.status, r.error) for r in results]
    assert results[0].tokens == results[1].tokens == results[2].tokens, \
        "a degenerate wire stream differs from its greedy twin's"
    return out


def degenerate_phase(dev, card):
    """Phase 14: (a) the kernels on the fixture, (b) the served streams,
    (c) the gateway; raises after reporting if any check differs."""
    t0 = time.perf_counter()
    kernels, bad = degenerate_kernels(dev)
    out = {"kernels": kernels}
    out.update(degenerate_streams(dev, card))
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 14 took {out['seconds']:.1f} s")
    assert not bad, "kernels differ from their plain versions on " \
        "degenerate rows: " + "; ".join(bad)
    return out


def degenerate_only(dev, card):
    """``--degenerate-only``: phase 14 alone; prints one JSON line."""
    out = degenerate_phase(dev, card)
    print(json.dumps({"degenerate_only": {
        "card": card, "seconds": out["seconds"],
        "gateway": out["gateway"],
        "twins": {c: out[c]["twins"] for c in ("contiguous", "paged")}}}))
    return 0


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


SHAPES = (("main", (B_MAIN, V_MAIN)), ("large", (B_LARGE, V_LARGE)))


def timing_record(timing, bounds, name, shape, B, V):
    """One kernel's numbers at one shape, from phase 2's timing and bounds;
    returns the record and the bytes its bound counts."""
    k_ms, p_ms, launch_ms, p_blocked = timing[shape][name]
    b_ms, b_by, nbytes = bounds[shape][name]
    return {"B": B, "V": V, "ms": k_ms, "kernel_ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "share": b_ms / k_ms,
            "library_ms": None, "launch_ms": launch_ms,
            "plain_blocked_host": p_blocked}, nbytes


def print_timing(name, shape, t, nbytes, launches, card):
    waited = " (plain call waited on the stream)" \
        if t["plain_blocked_host"] else ""
    print(f"{name} B={t['B']} V={t['V']} "
          f"({'warm in L2' if shape == 'main' else 'cold, rotated'}):"
          f" kernel {t['ms']:.4f} ms on the device ({t['launch_ms']:.4f} ms "
          f"a call with launch overhead), plain {t['plain_ms']:.4f} ms"
          f"{waited}, bound {t['bound_ms']:.5f} ms ({nbytes} bytes), share of bound "
          f"{t['share']:.1%}, launches {launches} [{card}]")


def sass_loops(lib, kernel, path):
    """The SASS of ``kernel`` (``cuobjdump -sass``, written to ``path``),
    its loops (for each backward branch, the instructions from its target
    to the branch and their opcodes) and its resources (``cuobjdump
    -res-usage``: registers, stack, local memory). Returns None where the
    toolkit has no cuobjdump."""
    import collections
    import re
    from repro_torch.kernels import _build
    tool = Path(_build.nvcc_path()).parent / "cuobjdump"
    if not tool.exists():
        return None
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    funcs = re.split(r"(?:^|\n)\s*Function : ", text)
    body = next(f for f in funcs[1:] if f.split()[0].find(kernel) >= 0)
    path.write_text(body)
    insns, labels, pending = [], {}, []
    for line in body.splitlines():
        lab = re.match(r"\s*(\.L_x_\d+):", line)
        if lab:
            pending.append(lab.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if not m:
            continue
        addr, ins = int(m.group(1), 16), m.group(2).strip()
        for name in pending:
            labels[name] = addr
        pending = []
        op = re.sub(r"^@!?U?P[T0-9]+\s+", "", ins).split()[0]
        insns.append((addr, op, ins))
    loops = []
    for addr, op, ins in insns:
        if not op.startswith("BRA"):
            continue
        tgt = re.search(r"`\((\.L_x_\d+)\)|(0x[0-9a-f]+)", ins)
        if tgt is None:
            continue
        to = labels.get(tgt.group(1)) if tgt.group(1) else int(tgt.group(2),
                                                                16)
        if to is not None and to < addr:
            ops = [o for a, o, _ in insns if to <= a <= addr]
            loops.append({"from": hex(to), "to": hex(addr),
                          "instructions": len(ops),
                          "opcodes": dict(collections.Counter(
                              o if o.startswith("MUFU") else o.split(".")[0]
                              for o in ops).most_common())})
    res = subprocess.run([str(tool), "-res-usage", str(lib)],
                         capture_output=True, text=True, check=True).stdout
    lines = res.splitlines()
    usage = next((lines[i + 1].strip() for i, line in enumerate(lines[:-1])
                  if "Function" in line and kernel in line), None)
    return {"instructions": len(insns), "loops": loops, "resources": usage}


def sm_clock_mhz(load, seconds=1.5):
    """The SM clock (``nvidia-smi`` ``clocks.sm``, median of samples every
    20 ms) while ``load`` is called back to back for ``seconds``."""
    import statistics
    import torch
    p = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits", "--loop-ms=20"],
                         stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                         text=True)
    try:
        t_end = time.perf_counter() + seconds
        while time.perf_counter() < t_end:
            load()
        torch.cuda.synchronize()
    finally:
        p.terminate()
        out = p.communicate()[0]
    vals = [float(x) for x in out.split() if x.replace(".", "").isdigit()]
    return statistics.median(vals) if vals else float("nan")


def issue_floor(sass, timing, dev):
    """The least time ``gumbel_argmax``'s float4 loop could take at each
    shape if each of the 132 SMs' four schedulers issued one warp
    instruction a cycle: columns x SASS instructions a column / 32 lanes /
    528 schedulers / SM clock, at the card's top clock (``clocks.max.sm``)
    and at the clock read while the kernel runs at B = 64. Returns
    {shape: {...}} beside the kernel's time, or None without the SASS."""
    import torch
    from repro_torch.kernels import gumbel_kernel
    loops = [lp for lp in (sass or {}).get("loops", [])
             if "LDG" in lp["opcodes"]]
    if not loops:
        return None
    per_col = loops[0]["instructions"] / 4
    top = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    z = torch.randn((B_LARGE, V_LARGE), device=dev)
    run = sm_clock_mhz(lambda: gumbel_kernel.gumbel_argmax(z, 1234))
    out = {}
    for shape, (B, V) in SHAPES:
        k_ms = timing[shape]["gumbel_argmax"][0]
        rec = {"instructions_a_column": per_col, "kernel_ms": k_ms,
               "clock_max_mhz": top, "clock_run_mhz": run}
        for name, mhz in (("max", top), ("run", run)):
            rec[f"floor_ms_{name}"] = B * V * per_col / 32 / (132 * 4) / (
                mhz * 1e6) * 1e3
        out[shape] = rec
        print(f"gumbel_argmax B={B} V={V}: issue floor "
              f"{rec['floor_ms_max']:.4f} ms at {top:.0f} MHz, "
              f"{rec['floor_ms_run']:.4f} ms at {run:.0f} MHz (the clock "
              f"read under the kernel at B={B_LARGE}) ({per_col} SASS "
              f"instructions a column, 528 schedulers); kernel {k_ms:.4f} ms")
    return out


def host_only(dev, card):
    """``--host-only``: phase 5's ``shvs`` rows on the device and in the
    host pool, in turns (device, host, host, device), then the pool alone
    at the main shape; prints one JSON line. Run it under different
    threading settings (``OMP_NUM_THREADS``, ``OMP_WAIT_POLICY``), one
    process each, to see what slows the engine thread in host mode."""
    import os
    import torch
    rows = [profile_steps(dev, card, names=(n,))
            for n in ("shvs", "shvs_host", "shvs_host", "shvs")]
    pool = pool_alone(dev, card, shapes=((B_MAIN, V_MAIN),))
    env = {k: os.environ.get(k) for k in ("OMP_NUM_THREADS",
                                          "OMP_WAIT_POLICY")}
    print(json.dumps({"host_only": {"card": card, "env": env,
                                    "torch_threads": torch.get_num_threads(),
                                    "rows": rows, "pool_alone": pool}}))
    return 0


def time_only(dev, card, src):
    """``--time-only``: phase 2's timing of the four kernels at both shapes,
    with no checks and no serving, for timing two trees in one call."""
    import torch
    import repro_torch
    gen = torch.Generator(device=dev).manual_seed(1234)
    timing = {"main": time_kernels(B_MAIN, V_MAIN, gen, dev, 1, 1),
              "large": time_kernels(B_LARGE, V_LARGE, gen, dev, 3, 2)}
    bounds = {s: kernel_bounds(*bv) for s, bv in SHAPES}
    out = {}
    for name in ("penalty_scale", "shvs_masses", "fused_sample",
                 "gumbel_argmax"):
        for shape, (B, V) in SHAPES:
            t, nbytes = timing_record(timing, bounds, name, shape, B, V)
            out.setdefault(name, {})[shape] = t
            print_timing(name, shape, t, nbytes, "-", card)
    print(json.dumps({"time_only": {"package": repro_torch.__file__,
                                    "src": src, "card": card,
                                    "kernels": out}}))
    return 0


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--time-only", action="store_true",
                    help="build the kernels and run phase 2's timing only "
                         "(no checks, no serving); prints one JSON line")
    ap.add_argument("--host-only", action="store_true",
                    help="build the kernels and profile the shvs decode "
                         "step on the device and in the host pool, in "
                         "turns, then the pool alone; prints one JSON line")
    ap.add_argument("--pipeline-only", action="store_true",
                    help="build the kernels and run phase 7 (the pipeline "
                         "engine) only; prints one JSON line")
    ap.add_argument("--migration-only", action="store_true",
                    help="build the kernels and run phase 8 (KV migration, "
                         "the handoff and the gateway) only; prints one "
                         "JSON line")
    ap.add_argument("--families-only", action="store_true",
                    help="build the kernels and run phases 3 and 9 (the "
                         "MoE, RWKV-6 and Zamba2 families) only; prints "
                         "one JSON line")
    ap.add_argument("--train-only", action="store_true",
                    help="build the kernels and run phase 10 (training, "
                         "the VLM and audio inputs, chunked attention) "
                         "only; prints one JSON line")
    ap.add_argument("--dist-only", action="store_true",
                    help="build the kernels and run phase 11 (the "
                         "distributed planes and the EP MoE: a one-rank "
                         "NCCL mesh, four gloo ranks on this card) only; "
                         "prints one JSON line")
    ap.add_argument("--tp-only", action="store_true",
                    help="build the kernels and run phase 12 (tensor-"
                         "parallel serving: launch/steps.py's programs on a "
                         "one-rank NCCL mesh and four gloo ranks on this "
                         "card) only; prints one JSON line")
    ap.add_argument("--mesh-train-only", action="store_true",
                    help="build the kernels and run phase 13 (the train "
                         "program on a one-rank NCCL mesh and four gloo "
                         "ranks on this card, the dry-run on fake CUDA "
                         "tensors, the examples) only; prints one JSON line")
    ap.add_argument("--degenerate-only", action="store_true",
                    help="build the kernels and run phase 14 (degenerate "
                         "decision rows: the kernels on the fixture, the "
                         "served streams, the gateway) only; prints one "
                         "JSON line")
    ap.add_argument("--dist-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--mt-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--tp-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--dist-world", type=int, default=4,
                    help=argparse.SUPPRESS)
    ap.add_argument("--dist-port", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--dist-dir", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dist-device", default="cuda", help=argparse.SUPPRESS)
    ap.add_argument("--switch-interval", type=float, default=None,
                    help="sys.setswitchinterval(seconds) before anything "
                         "runs: how often Python threads (the gateway's "
                         "replicas, its event loop) hand over the "
                         "interpreter lock")
    ap.add_argument("--src", default=None,
                    help="with --time-only: time the repro_torch package "
                         "under this directory instead of ./src")
    args = ap.parse_args()
    if args.switch_interval is not None:
        sys.setswitchinterval(args.switch_interval)
    if args.src:
        sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    if args.dist_rank is not None:          # one of phase 11's ranks
        return dist_rank_main(args)
    if args.tp_rank is not None:            # one of phase 12's ranks
        return tp_rank_main(args)
    if args.mt_rank is not None:            # one of phase 13's ranks
        return mt_rank_main(args)
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
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    tag = f"{Path(args.src).resolve().parent.name}." if args.src else ""
    sass = sass_loops(lib, "gumbel_argmax_kernel",
                      out / f"{tag}gumbel_argmax_kernel.sass")
    if sass is None:
        print("gumbel_argmax_kernel SASS: no cuobjdump in the toolkit")
    else:
        # the loop that loads z is the float4 loop: four columns a pass
        for loop in sass["loops"]:
            if "LDG" in loop["opcodes"]:
                print(f"gumbel_argmax_kernel SASS float4 loop {loop['from']}-"
                      f"{loop['to']}: {loop['instructions']} instructions, "
                      f"{loop['instructions'] / 4} a column: "
                      f"{loop['opcodes']}")
        print(f"gumbel_argmax_kernel SASS: {sass['instructions']} "
              f"instructions, {len(sass['loops'])} backward branches; "
              f"resources {sass['resources']}")
    if args.time_only:
        return time_only(dev, card, args.src)
    if args.host_only:
        return host_only(dev, card)
    if args.pipeline_only:
        return pipeline_only(dev, card)
    if args.migration_only:
        return migration_only(dev, card)
    if args.families_only:
        return families_only(dev, card)
    if args.train_only:
        return train_only(dev, card)
    if args.dist_only:
        return dist_only(dev, card)
    if args.tp_only:
        return tp_only(dev, card)
    if args.mesh_train_only:
        return mesh_train_only(dev, card)
    if args.degenerate_only:
        return degenerate_only(dev, card)

    t_phase = time.perf_counter()

    def phase_done(n):
        nonlocal t_phase
        now = time.perf_counter()
        print(f"phase {n} took {now - t_phase:.1f} s")
        t_phase = now

    err, timing, bounds, large_k = check_kernels(dev)
    phase_done(2)
    model_err = check_model(dev)
    phase_done(3)
    runs, counts = serve(dev, card)
    paged_runs, counts["gumbel_paged"] = serve_paged(dev, card)
    runs.update(paged_runs)
    phase_done(4)
    steps = profile_steps(dev, card)
    phase_done(5)
    host_runs = serve_host(dev, card)
    phase_done(6)
    pipeline_runs = serve_pipeline(dev, card)
    phase_done(7)
    migration_runs = serve_migration(dev, card)
    phase_done(8)
    family_runs, family_counts = serve_families(dev, card)
    phase_done(9)
    train_runs = train_phase(dev, card)
    phase_done(10)
    dist_runs = dist_phase(dev, card)          # prints its own seconds
    tp_runs = tp_phase(dev, card)              # prints its own seconds
    mt_runs = mesh_train_phase(dev, card)      # prints its own seconds
    degenerate = degenerate_phase(dev, card)   # prints its own seconds

    launch_of = {"penalty_scale": counts["shvs"]["penalty_scale"],
                 "shvs_masses": counts["shvs"]["shvs_masses"],
                 "fused_sample": counts["fused"]["fused_sample"],
                 "gumbel_argmax": counts["gumbel_paged"]["gumbel_argmax"]}
    kernels = []
    for mod in (penalty_kernel, shvs_kernel, fused_kernel, gumbel_kernel):
        rec = {"name": mod.NAME, "route": "cuda", "source": mod.SOURCE,
               "replaces": mod.REPLACES, "launches": launch_of[mod.NAME],
               "max_abs_err": err[mod.NAME]}
        for shape, (B, V) in SHAPES:
            t, nbytes = timing_record(timing, bounds, mod.NAME, shape, B, V)
            if shape == "main":
                rec.update(t)
            else:
                rec["large"] = t
            print_timing(mod.NAME, shape, t, nbytes, launch_of[mod.NAME],
                         card)
        kernels.append(rec)
    floor = issue_floor(sass, timing, dev)
    report = {"card": card, "torch": torch.__version__, "kernels": kernels,
              "model_check_max_abs_err": model_err, "runs": runs,
              "step_profile": steps, "host_placement": host_runs,
              "pipeline": pipeline_runs, "migration": migration_runs,
              "families": family_runs, "family_launches": family_counts,
              "training": train_runs, "distribution": dist_runs,
              "tensor_parallel": tp_runs, "mesh_train": mt_runs,
              "degenerate": degenerate,
              "fused_large_k": large_k,
              "gumbel_sass": sass,
              "gumbel_issue_floor": floor}
    (out / "chip_smoke_report.json").write_text(json.dumps(report, indent=1))
    assert set(ops.launch_counts()) == {k["name"] for k in kernels}
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
