"""Card-only tests of the PyTorch port (marker ``gpu``): each CUDA kernel
against its plain version, and the engine on CUDA against the engine on
the CPU. They skip where torch sees no CUDA device; this file imports
neither JAX nor the reference package, so it runs on a machine without
them:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

from repro_torch.config import SamplingConfig, SHVSConfig, get_arch
from repro_torch.core import penalties as pen
from repro_torch.core.decision_plane import DecisionPlane
from repro_torch.core.host_sampler import HostSamplerPool
from repro_torch.engine.engine import Engine, EngineConfig, SlotParams
from repro_torch.engine.pipeline import PipelineConfig, PipelineEngine
from repro_torch.kernels import (fused_kernel, gumbel_kernel, penalty_kernel,
                                 ref, shvs_kernel)
from repro_torch.launch.serve import synth_requests
from repro_torch.models.model import Model
from repro_torch.obs import StepTracer, Telemetry
from torch_degenerate_rows import (CASES as DEGENERATE, FUSED, case,
                                   kernel_rows, probe_inputs, tensors)

pytestmark = pytest.mark.gpu


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(B, V, seed, dev, hot):
    """Seeded inputs at a logit scale where the top-K mass stays clear of
    1.0 in f32 (ROADMAP 'Faults')."""
    rs = np.random.default_rng(seed)
    sparse = lambda: (rs.integers(0, 3, (B, V)) *
                      (rs.random((B, V)) < 0.1)).astype(np.int32)
    temp = rs.uniform(0.5, 1.5, B).astype(np.float32)
    temp[rs.random(B) < 0.2] = 0.0
    x = dict(z=rs.normal(0, 1.5, (B, V)).astype(np.float32), cp=sparse(),
             co=sparse(), rep=rs.uniform(1, 2, B).astype(np.float32),
             pres=rs.uniform(0, 1, B).astype(np.float32),
             freq=rs.uniform(0, 0.5, B).astype(np.float32), temp=temp,
             top_k=rs.choice([0, 0, 1, 40, 300], B).astype(np.int32),
             top_p=rs.choice([1.0, 1.0, 0.95, 0.5], B).astype(np.float32),
             min_p=rs.choice([0.0, 0.0, 0.05], B).astype(np.float32),
             u=rs.random(B).astype(np.float32),
             hot={"all": np.ones(V, bool), "none": np.zeros(V, bool),
                  "random": rs.random(V) < 0.3}[hot])
    return {k: torch.from_numpy(v).to(dev) for k, v in x.items()}


_PEN = ("z", "cp", "co", "rep", "pres", "freq", "temp")
_FUSED = _PEN + ("top_k", "top_p", "min_p", "u", "hot")


@pytest.mark.parametrize("B,V,hot", [(1, 300, "random"), (3, 700, "all"),
                                     (8, 49152, "random"), (5, 50021, "none")])
def test_kernels_match_plain_versions(B, V, hot):
    dev = _cuda()
    x = _inputs(B, V, V, dev, hot)
    pen = [x[k] for k in _PEN]
    zs = ref.penalty_ref(*pen)
    assert torch.equal(penalty_kernel.penalty_scale(*pen), zs)
    got = shvs_kernel.shvs_masses(zs, x["hot"])
    want = ref.shvs_mass_ref(zs, x["hot"])
    assert torch.equal(got[0], want[0]) and torch.equal(got[3], want[3])
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=0)
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=0)
    f = [x[k] for k in _FUSED]
    got = fused_kernel.fused_sample(*f, k_cap=256, block_v=2048)
    want = ref.fused_sample_ref(*f, k_cap=256, block_v=2048)
    for i in (0, 1, 3):                  # tokens, exact, kept
        assert torch.equal(got[i], want[i])
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=0)


@pytest.mark.parametrize("B,V", [(8, 49152), (64, 151936), (8, 50021)])
@pytest.mark.parametrize("name", DEGENERATE)
def test_kernels_match_plain_versions_on_degenerate_rows(name, B, V):
    """The degenerate rows of ``torch_degenerate_rows`` (the CPU tests hold
    the plain versions to the reference on them): all four kernels, and
    ``fused_sample`` at k_cap 256 and 2048 on both paths, equal their
    plain versions on every row, with no CUDA error."""
    dev = _cuda()
    res = kernel_rows(tensors(case(name, B, V, seed=B + V), dev))
    assert not res["differ"], res["differ"]


def test_fused_sample_probe_keeps_nothing_and_draws_in_bounds():
    """ROADMAP Fault 10's probe (B = 3, V = 1000, k_cap 64, min_p = 2):
    nothing is kept, and the draw is the top logit, as in the plain
    version, where the kernel once read past its list."""
    dev = _cuda()
    x = probe_inputs(dev)
    res = kernel_rows(x, k_caps=(64,))
    assert not res["differ"], res["differ"]
    tokens, _, _, kept = fused_kernel.fused_sample(
        *[x[k] for k in FUSED], k_cap=64, block_v=2048)
    torch.cuda.synchronize()
    assert kept.tolist() == [0, 0, 0]
    assert tokens.tolist() == x["logits"].argmax(-1).tolist()


def _hazard_rows(x, V, chunk, C):
    """Row 0 (τ = 0): equal maxima at column 3 of each CTA's range, zero
    counts there; row 1: all equal, zero counts; row 2: -1e30 on its first
    two thirds; last row: top_k = 1. Returns row 0's tied columns."""
    B = x["z"].shape[0]
    ties = sorted({min(r * chunk + 3, V - 1) for r in range(C)})
    x["temp"][0] = 0.0
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


@pytest.mark.parametrize("B,V,block_v", [
    (8, 300, 2048), (8, 2049, 2049), (3, 4100, 4100), (8, 50021, 2048),
    (1, 49152, 2048), (8, 49152, 2048), (64, 151936, 2048)])
def test_cluster_split_hazards(B, V, block_v):
    """The row split over a cluster: CTAs with fewer than K columns (V =
    2049 and 4100 as one tile), rows not 16-byte aligned (V odd), equal
    maxima in different CTAs (the lowest column wins), an all-equal row,
    -1e30 entries, τ = 0 and top_k = 1 rows, B = 1 and B = 64; two
    launches give the same bits."""
    dev = _cuda()
    x = _inputs(B, V, V + B, dev, "random")
    Vp = -(-V // block_v) * block_v
    sf = fused_kernel.split(B, Vp, min(256, Vp))
    ties = _hazard_rows(x, V, sf["chunk"], sf["C"])
    zs = ref.penalty_ref(*[x[k] for k in _PEN])
    got = shvs_kernel.shvs_masses(zs, x["hot"])
    again = shvs_kernel.shvs_masses(zs, x["hot"])
    want = ref.shvs_mass_ref(zs, x["hot"])
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    assert torch.equal(got[0], want[0]) and torch.equal(got[3], want[3])
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=0)
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=0)
    f = [x[k] for k in _FUSED]
    got = fused_kernel.fused_sample(*f, k_cap=256, block_v=block_v)
    again = fused_kernel.fused_sample(*f, k_cap=256, block_v=block_v)
    want = ref.fused_sample_ref(*f, k_cap=256, block_v=block_v)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    for i in (0, 1, 3):                  # tokens, exact, kept
        assert torch.equal(got[i], want[i])
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=0)
    assert int(got[0][0]) == ties[0]


def test_cluster_split_sizes():
    """More than one CTA a row at the main path's B = 8, V = 49152."""
    _cuda()
    assert shvs_kernel.split(8, 49152)["C"] == 16
    assert fused_kernel.split(8, 49152, 256)["C"] == 16
    assert fused_kernel.split(64, 153600, 256)["C"] == 16
    assert fused_kernel.split(8, 2049, 256)["C"] == 2
    sg = gumbel_kernel.split(8, 49152)
    assert (sg["C"], sg["chunk"], sg["threads"]) == (16, 3072, 256)
    sg = gumbel_kernel.split(64, 151936)
    assert (sg["C"], sg["grid"], sg["chunk"]) == (16, (16, 64), 9504)
    assert sg["max_active_clusters"] > 0
    assert gumbel_kernel.split(8, 300)["C"] == 1
    assert gumbel_kernel.split(3, 4100)["C"] == 4


def test_gumbel_noise_is_logf_at_every_hash_value():
    """The kernel's noise (logf without its special-case paths) equals
    -logf(-logf(u)) bit for bit at all 2^32 hash values."""
    assert gumbel_kernel.noise_check(_cuda()) == 0


# (B, V) -> (seed, column): the hash gives u == 1.0 at that column of row
# B - 1 and at no lower column of that row
GUMBEL_U_ONE = {(8, 300): (54539826, 226), (8, 2049): (4864, 1572),
                (3, 4100): (280, 629), (8, 50021): (347, 15666),
                (1, 49152): (324, 32466), (8, 49152): (347, 15666),
                (64, 151936): (170, 142141)}


@pytest.mark.parametrize("B,V", list(GUMBEL_U_ONE))
def test_gumbel_cluster_split_hazards(B, V):
    """The row split of gumbel_argmax: one CTA (V = 300), CTAs of fewer
    than 2048 columns or none (V = 2049, 4100), rows not 16-byte aligned
    (V odd), B = 1 and B = 64. +inf at column 3 of every CTA's range (the
    lowest wins), NaNs in two or three ranges (the first wins), -1e30
    entries, and a -1e30 operand under a seed whose u == 1.0 column must
    win; two launches give equal tokens."""
    dev = _cuda()
    sg = gumbel_kernel.split(B, V)
    C, chunk = sg["C"], sg["chunk"]
    z = np.random.default_rng(V + B).normal(0, 2, (B, V)).astype(np.float32)
    infs = sorted({min(r * chunk + 3, V - 1) for r in range(C)})
    nans = sorted({min(r * chunk + 5, V - 1) for r in {C // 2, C - 1}}
                  | {min(max(C // 2 - 1, 0) * chunk + 9, V - 1)})
    z[0, infs] = np.inf
    if B > 1:
        z[1, nans] = np.nan
    if B > 2:
        z[2, :2 * V // 3] = -1e30
    zt = torch.from_numpy(z).to(dev)
    got = gumbel_kernel.gumbel_argmax(zt, 1234)
    assert torch.equal(got, gumbel_kernel.gumbel_argmax(zt, 1234))
    assert torch.equal(got, ref.gumbel_argmax_ref(zt, 1234))
    assert int(got[0]) == infs[0]
    if B > 1:
        assert int(got[1]) == nans[0]
    seed, col = GUMBEL_U_ONE[B, V]
    zt = torch.full((B, V), -1e30, device=dev)
    got = gumbel_kernel.gumbel_argmax(zt, seed)
    assert torch.equal(got, ref.gumbel_argmax_ref(zt, seed))
    assert int(got[-1]) == col


def test_kernel_wrappers_reject_what_the_kernels_do_not_take():
    dev = _cuda()
    z = torch.zeros((2, 64), device=dev)
    hot = torch.zeros(64, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        shvs_kernel.shvs_masses(z.t().contiguous().t(), hot)
    with pytest.raises(ValueError, match="float32"):
        shvs_kernel.shvs_masses(z.double(), hot)
    with pytest.raises(ValueError, match="CUDA"):
        shvs_kernel.shvs_masses(z.cpu(), hot.cpu())
    zi = torch.zeros((2, 64), dtype=torch.int32, device=dev)
    row = torch.ones(2, device=dev)
    args = (z, zi, zi, row, row, row, row, zi[:, 0].contiguous(), row, row,
            row, hot)
    with pytest.raises(ValueError, match="path"):
        fused_kernel.fused_sample(*args, k_cap=64, block_v=64, path="smem")
    big = torch.zeros((1, fused_kernel.MAX_VP + 1), device=dev)
    with pytest.raises(ValueError, match="padded V"):
        fused_kernel.fused_sample(big, *args[1:], k_cap=64, block_v=2048)


@pytest.mark.parametrize("B,V,k_cap", [(8, 49152, 2048), (8, 49152, 16384),
                                       (8, 49152, None), (8, 151936, None)])
def test_fused_large_k_matches_plain_version(B, V, k_cap):
    """K past the old 1024 cap, up to the padded V (None): the kernel on
    the path it picks and on the global path equals the plain version in
    tokens and alpha (to rounding) and the two paths equal each other bit
    for bit. kept and exact are compared where the kept mass stays clear
    of 1.0 (ROADMAP 'Faults' 1): rows with an explicit top_k, and every
    row while K < padded V."""
    dev = _cuda()
    x = _inputs(B, V, V + 7, dev, "random")
    f = [x[k] for k in _FUSED]
    Vp = -(-V // 2048) * 2048
    K = Vp if k_cap is None else k_cap
    auto = fused_kernel.split(B, Vp, K)
    assert auto["path"] == ("global" if K > 16384 else "shared")
    assert fused_kernel.split(B, Vp, K, "global")["path"] == "global"
    want = ref.fused_sample_ref(*f, k_cap=K, block_v=2048)
    got = fused_kernel.fused_sample(*f, k_cap=K, block_v=2048)
    forced = fused_kernel.fused_sample(*f, k_cap=K, block_v=2048,
                                       path="global")
    assert all(torch.equal(g, h) for g, h in zip(got, forced))
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=0)
    clear = x["top_k"] > 0 if K == Vp else torch.ones(B, dtype=torch.bool,
                                                      device=dev)
    for i in (1, 3):                     # exact, kept
        assert torch.equal(got[i][clear], want[i][clear])


@pytest.mark.parametrize("B,V,seed", [(1, 300, 0), (3, 50021, 42),
                                      (8, 49152, 324), (8, 49152, 3000009007)])
def test_gumbel_kernel_matches_plain_version(B, V, seed):
    """Tokens equal, with -1e30 entries, a NaN row and (seed 324, row 0 of
    a V = 49152 operand) the hash's u == 1.0 at column 32466."""
    dev = _cuda()
    rs = np.random.default_rng(V + seed % 1000)
    z = rs.normal(0, 2, (B, V)).astype(np.float32)
    z[-1, : V // 3] = -1e30
    if B > 2:
        z[1, [5, 9]] = np.nan
    zt = torch.from_numpy(z).to(dev)
    got = gumbel_kernel.gumbel_argmax(zt, seed)
    want = ref.gumbel_argmax_ref(zt, seed)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    if seed == 324 and V == 49152:
        zero = torch.zeros((1, V), device=dev)
        assert int(gumbel_kernel.gumbel_argmax(zero, seed)[0]) == 32466


@pytest.mark.parametrize("algorithm", ["shvs", "fused"])
def test_engine_on_cuda_matches_engine_on_cpu(algorithm):
    dev = _cuda()
    cfg = get_arch("smollm-360m").reduced()
    params = Model(cfg).init(seed=1, device="cpu")
    to = lambda t: {k: to(v) if isinstance(v, dict) else v.to(dev)
                    for k, v in t.items()}
    streams = []
    for device, p in (("cpu", params), (dev, to(params))):
        eng = Engine(cfg, p, EngineConfig(
            max_batch=4, max_seq_len=64, algorithm=algorithm,
            shvs=SHVSConfig(hot_size=128), k_cap=64), device=device)
        reqs = synth_requests(3, cfg.vocab_size, 6, seed=5) + \
            synth_requests(3, cfg.vocab_size, 6, rng_seed=1, greedy=True)
        for i, r in enumerate(reqs):
            r.request_id = i
        list(eng.generate(reqs))
        eng.close()
        streams.append([(r.output, r.finish_reason) for r in reqs])
    assert streams[0] == streams[1]


@pytest.mark.parametrize("mode,cache,algorithm", [
    ("disaggregated", "contiguous", "shvs"), ("baseline", "contiguous", "shvs"),
    ("baseline", "paged", "fused"), ("disaggregated", "paged", "shvs")])
def test_pipeline_engine_on_cuda_matches_cpu(mode, cache, algorithm):
    """The pipeline engine (2 stages, 4 microbatches of 2 rows) on CUDA
    against itself on the CPU, on a 4-layer reduced f32 model: baseline
    draws through the kernels on the card (``fused`` with k_cap = 2048,
    which the engine caps at V = 512), disaggregated in the host pool."""
    dev = _cuda()
    cfg = dataclasses.replace(get_arch("smollm-360m").reduced(),
                              num_layers=4)
    params = Model(cfg).init(seed=2, device="cpu")
    to = lambda t: {k: to(v) if isinstance(v, dict) else v.to(dev)
                    for k, v in t.items()}
    streams = []
    for device, p in (("cpu", params), (dev, to(params))):
        eng = PipelineEngine(cfg, p, PipelineConfig(
            max_batch=8, max_seq_len=64, algorithm=algorithm,
            shvs=SHVSConfig(hot_size=128), k_cap=2048, stages=2,
            microbatches=4, sampler_mode=mode, cache=cache, block_size=16),
            device=device)
        reqs = synth_requests(5, cfg.vocab_size, 6, seed=5) + \
            synth_requests(4, cfg.vocab_size, 6, rng_seed=1, greedy=True)
        for i, r in enumerate(reqs):
            r.request_id = i
        list(eng.generate(reqs))
        eng.close()
        streams.append([(r.output, r.finish_reason) for r in reqs])
    assert streams[0] == streams[1]


@pytest.mark.parametrize("overlap", [True, False])
def test_paged_chunked_gumbel_engine_on_cuda_matches_cpu(overlap):
    """The gumbel backend over the paged cache with chunked prefill, long
    prompts and a pool small enough to preempt: the same streams on CUDA
    as on the CPU."""
    dev = _cuda()
    cfg = get_arch("smollm-360m").reduced()
    params = Model(cfg).init(seed=1, device="cpu")
    to = lambda t: {k: to(v) if isinstance(v, dict) else v.to(dev)
                    for k, v in t.items()}
    streams = []
    for device, p in (("cpu", params), (dev, to(params))):
        eng = Engine(cfg, p, EngineConfig(
            max_batch=4, max_seq_len=256, algorithm="gumbel", k_cap=64,
            cache="paged", block_size=16, num_blocks=16, prompt_chunk=32,
            overlap=overlap, seed=3000), device=device)
        reqs = synth_requests(8, cfg.vocab_size, 24, long_prompts=True,
                              seed=5)
        for r in reqs[::2]:
            r.sampling = dataclasses.replace(r.sampling, top_k=0, top_p=1.0)
        list(eng.generate(reqs))
        eng.close()
        assert eng.scheduler.preemptions > 0
        streams.append([(r.output, r.finish_reason) for r in reqs])
    assert streams[0] == streams[1]


@pytest.mark.parametrize("overlap", [True, False])
def test_host_mode_engine_on_cuda_matches_cpu(overlap):
    """Host placement on the card (the logits' pinned copy and event, the
    histogram rows crossing at admission and around chunk draws) over the
    paged cache with chunked prefill and preemption: the same streams as
    host placement on the CPU."""
    dev = _cuda()
    cfg = get_arch("smollm-360m").reduced()
    params = Model(cfg).init(seed=1, device="cpu")
    to = lambda t: {k: to(v) if isinstance(v, dict) else v.to(dev)
                    for k, v in t.items()}
    streams = []
    for device, p in (("cpu", params), (dev, to(params))):
        eng = Engine(cfg, p, EngineConfig(
            max_batch=4, max_seq_len=256, algorithm="shvs",
            shvs=SHVSConfig(hot_size=128), k_cap=64, cache="paged",
            block_size=16, num_blocks=16, prompt_chunk=32, overlap=overlap,
            sampler_mode="host", samplers=2), device=device)
        reqs = synth_requests(8, cfg.vocab_size, 24, long_prompts=True,
                              seed=5)
        list(eng.generate(reqs))
        eng.close()
        assert eng.scheduler.preemptions > 0
        assert eng.pstate.prompt_counts.device.type == "cpu"
        streams.append([(r.output, r.finish_reason) for r in reqs])
    assert streams[0] == streams[1]


def _pool_inputs(B, V, dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    logits = torch.randn((B, V), generator=gen, device=dev) * 1.5
    sp = SlotParams(B, V, "cpu")
    for b in range(B):
        sp.set_row(b, SamplingConfig(
            temperature=(0.0, 0.8, 1.0, 0.7)[b % 4],
            top_k=(0, 40, 0, 1)[b % 4], top_p=(1.0, 0.95, 0.9, 1.0)[b % 4],
            repetition_penalty=1.1, seed=b if b % 3 else None))
    z = torch.zeros((B, V), dtype=torch.int32)
    state = pen.PenaltyState(z, z.clone())
    return (logits, state, sp.host_params(), None,
            np.arange(B, dtype=np.uint32), np.full(B, 3, np.int32), 7,
            np.ones(B, bool))


def test_host_pool_transfer_excludes_later_kernels():
    """The copy and its event are enqueued at submit: a long kernel
    enqueued after it is not in ``transfer_time``; one enqueued before it
    is."""
    dev = _cuda()
    V = 49152
    plane = DecisionPlane(V, algorithm="shvs", shvs=SHVSConfig(hot_size=1024),
                          k_cap=256, seed=0, device=dev)
    pool = HostSamplerPool(plane, 2)
    sleep_s = 0.3                # the least a 1e9-cycle sleep lasts (<2 GHz)
    try:
        args = _pool_inputs(8, V, dev)
        pool.submit(*args).result()                  # warm the pool
        torch.cuda.synchronize()
        ticket = pool.submit(*args)
        torch.cuda._sleep(1_000_000_000)            # after the event
        after = ticket.result()
        torch.cuda.synchronize()
        torch.cuda._sleep(1_000_000_000)            # before the copy
        before = pool.submit(*args).result()
    finally:
        pool.close()
    assert after.transfer_time < sleep_s / 2, after.transfer_time
    assert before.transfer_time >= sleep_s, before.transfer_time
    np.testing.assert_array_equal(after.tokens, before.tokens)


def test_host_pool_tokens_equal_across_worker_counts():
    """B = 64, V = 151936 (qwen3-8b's vocabulary), logits made on the card:
    1, 2, 4 and 8 workers commit the same tokens and histograms."""
    dev = _cuda()
    B, V = 64, 151936
    plane = DecisionPlane(V, algorithm="shvs", shvs=SHVSConfig(hot_size=1024),
                          k_cap=256, seed=0, device=dev)
    args = _pool_inputs(B, V, dev, seed=11)
    out = []
    for workers in (1, 2, 4, 8):
        pool = HostSamplerPool(plane, workers)
        try:
            out.append(pool.submit(*args).result())
        finally:
            pool.close()
    for res in out[1:]:
        np.testing.assert_array_equal(res.tokens, out[0].tokens)
        assert torch.equal(res.state.output_counts, out[0].state.output_counts)
    assert out[0].active_rows == B


def _bf16_engine(cfg, params, dev, cache, **kw):
    return Engine(cfg, params, EngineConfig(
        max_batch=4, max_seq_len=64, algorithm="shvs",
        shvs=SHVSConfig(hot_size=128), k_cap=64, cache=cache, block_size=16,
        **kw), device=dev)


@pytest.mark.parametrize("cache", ["contiguous", "paged"])
def test_kv_payload_bf16_roundtrip_on_cuda_is_bitwise(cache):
    """A bf16 engine on the card exports a request mid-decode: the
    payload's K/V are the cache rows bit for bit, survive ``to_bytes`` →
    ``from_bytes`` bit for bit, and after the import the target's cache
    and histogram rows are the payload's bits."""
    from repro_torch.engine import KVPayload
    from repro_torch.engine.paged_cache import gather_slot_kv
    dev = _cuda()
    cfg = dataclasses.replace(get_arch("smollm-360m").reduced(),
                              dtype="bfloat16")
    params = Model(cfg).init(seed=4, device=dev)
    a, b = (_bf16_engine(cfg, params, dev, cache) for _ in range(2))
    bits = lambda t: t.contiguous().view(torch.int16)

    def rows(eng, slot, T):
        if cache == "paged":
            return gather_slot_kv(eng.cache, eng.alloc.owned[slot], T,
                                  eng.pcfg)
        return eng.cache["k"][:, slot, :T], eng.cache["v"][:, slot, :T]

    try:
        reqs = synth_requests(3, cfg.vocab_size, 12, seed=5)
        a.submit(reqs)
        while len(reqs[1].output) < 3:
            a.step()
        a.flush()
        r = reqs[1]
        slot, T = r.slot, int(a.cache["len"][r.slot])
        src_k, src_v = (t.clone() for t in rows(a, slot, T))
        p = a.export_request(r.request_id)
        assert p.k.dtype == torch.bfloat16 and p.kv_len == T
        assert torch.equal(bits(p.k), bits(src_k))
        assert torch.equal(bits(p.v), bits(src_v))
        q = KVPayload.from_bytes(p.to_bytes())
        assert torch.equal(bits(q.k), bits(p.k).cpu())
        assert torch.equal(bits(q.v), bits(p.v).cpu())
        assert torch.equal(q.output_counts, p.output_counts.cpu())
        landed = b.import_request(q)
        b.step()              # admission installs the payload, then decodes
        b.flush()
        got_k, got_v = rows(b, landed.slot, T)
        assert torch.equal(bits(got_k), bits(q.k).to(dev))
        assert torch.equal(bits(got_v), bits(q.v).to(dev))
        # the histograms: the payload's rows plus the one token decoded here
        assert torch.equal(b.pstate.prompt_counts[landed.slot].cpu(),
                           q.prompt_counts)
        want = q.output_counts.clone()
        for t in landed.output[len(q.output):]:
            want[t] += 1
        assert len(landed.output) == len(q.output) + 1
        assert torch.equal(b.pstate.output_counts[landed.slot].cpu(), want)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("cache,algorithm,chunk", [
    ("contiguous", "shvs", 0), ("paged", "gumbel", 32)])
def test_handoff_identity_on_cuda(cache, algorithm, chunk):
    """The handoff scheduler on the card (bf16, filtered sampling and
    greedy rows) gives the never-migrated engine's streams."""
    from repro_torch.engine import HandoffScheduler
    dev = _cuda()
    cfg = dataclasses.replace(get_arch("smollm-360m").reduced(),
                              dtype="bfloat16")
    params = Model(cfg).init(seed=4, device=dev)
    kw = dict(algorithm=algorithm, prompt_chunk=chunk)

    def batch():
        reqs = synth_requests(4, cfg.vocab_size, 10, seed=5,
                              long_prompts=True) + \
            synth_requests(4, cfg.vocab_size, 10, rng_seed=1, greedy=True)
        for i, r in enumerate(reqs):
            r.request_id = i
        return reqs

    eng = Engine(cfg, params, EngineConfig(
        max_batch=8, max_seq_len=256, shvs=SHVSConfig(hot_size=128),
        k_cap=64, cache=cache, **kw), device=dev)
    single = batch()
    list(eng.generate(single))
    eng.close()
    hs = HandoffScheduler(*(Engine(cfg, params, EngineConfig(
        max_batch=8, max_seq_len=256, shvs=SHVSConfig(hot_size=128),
        k_cap=64, cache=cache, **kw), device=dev) for _ in range(2)))
    moved = batch()
    try:
        list(hs.generate(moved))
    finally:
        hs.close()
    assert hs.migrated == len(moved)
    assert [(r.output, r.finish_reason) for r in moved] == \
        [(r.output, r.finish_reason) for r in single]


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "llama4-maverick-400b-a17b", "rwkv6-3b",
                                  "zamba2-1.2b"])
def test_family_forward_on_cuda_matches_cpu(arch):
    """Reduced f32 families (granite at a capacity factor that drops
    pairs): right-padded prefill + 3 decode steps, logits and every cache
    leaf at 1e-4."""
    dev = _cuda()
    cfg = get_arch(arch).reduced()
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=0.5))
    model = Model(cfg)
    params = model.init(seed=5, device="cpu")
    gen = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (3, 20), generator=gen,
                         dtype=torch.int32)
    lens = torch.tensor([20, 11, 7], dtype=torch.int32)
    steps = torch.randint(0, cfg.vocab_size, (3, 3), generator=gen,
                          dtype=torch.int32)
    outs = []
    for d, p in (("cpu", params), (dev, _to(params, dev))):
        cache = model.init_cache(3, 32, device=d)
        logits, cache = model.prefill(p, {"tokens": toks.to(d)}, cache,
                                      true_lens=lens.to(d))
        seq = [logits.cpu()]
        for nxt in steps:
            logits, cache = model.decode_step(p, nxt.to(d), cache)
            seq.append(logits.cpu())
        outs.append((seq, {k: v.cpu() for k, v in cache.items()}))
    (a, ca), (b, cb) = outs
    for x, y in zip(a, b):
        torch.testing.assert_close(y, x, rtol=1e-4, atol=1e-4)
    for k in ca:
        torch.testing.assert_close(cb[k], ca[k], rtol=1e-4, atol=1e-4)


def test_moe_decode_steps_make_no_synchronising_call():
    """Reduced granite (``shvs``, overlapped): steady-state decode steps,
    the router's sort and the capacity dispatch included, never block the
    host on the stream."""
    dev = _cuda()
    cfg = get_arch("granite-moe-1b-a400m").reduced()
    eng = Engine(cfg, Model(cfg).init(seed=0, device=dev), EngineConfig(
        max_batch=4, max_seq_len=64, algorithm="shvs",
        shvs=SHVSConfig(hot_size=128), k_cap=64), device=dev)
    eng.submit(synth_requests(4, cfg.vocab_size, 12, seed=0))
    eng.step()                  # admission reads the first tokens back
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            eng.step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    eng.flush()
    eng.close()


def test_device_timed_spans_on_cuda():
    """Reduced granite with the tracer on: the steady decode steps and the
    reads of the tracer never block the host; once the stream is done
    every device-timed span has a positive ``device_ms``, no larger than
    its enclosing ``dispatch``'s; a read before a span's end event has
    completed leaves ``device_ms`` unset rather than waiting."""
    dev = _cuda()
    cfg = get_arch("granite-moe-1b-a400m").reduced()
    eng = Engine(cfg, Model(cfg).init(seed=0, device=dev), EngineConfig(
        max_batch=4, max_seq_len=64, algorithm="shvs",
        shvs=SHVSConfig(hot_size=128), k_cap=64), device=dev,
        telemetry=Telemetry(tracer=StepTracer(capacity=1 << 14)))
    eng.submit(synth_requests(4, cfg.vocab_size, 12, seed=0))
    eng.step()                  # admission reads the first tokens back
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            eng.step()
            eng.tracer.events()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    eng.flush()
    eng.close()
    torch.cuda.synchronize(dev)
    evs = eng.tracer.events()
    timed = [e for e in evs
             if e.kind in ("dispatch", "device_sample", "moe_route")]
    kinds = {e.kind for e in timed}
    assert kinds == {"dispatch", "device_sample", "moe_route"}
    ms = lambda e: dict(e.args)["device_ms"]
    assert all(ms(e) > 0 for e in timed)
    dispatches = [e for e in timed if e.kind == "dispatch"]
    # the first decode step runs eagerly, the later ones replay the step's
    # CUDA graphs (engine/step_graph.py), which record the same spans
    assert [dict(d.args)["graph"] for d in dispatches] == [0, 1, 1, 1]
    for d in dispatches:
        inner = [e for e in timed if e is not d and d.ts <= e.ts
                 and e.end <= d.end]
        assert len(inner) == 1 + cfg.num_layers     # decision + routing
        assert all(ms(e) <= ms(d) for e in inner)

    tr = StepTracer()
    with tr.span("device_sample", device=dev, program="decode", rows=1,
                 step=0):
        torch.cuda._sleep(int(2e8))      # ~0.1 s of the stream
    t0 = time.perf_counter()
    (early,) = tr.events()
    took = time.perf_counter() - t0
    assert "device_ms" not in dict(early.args) and took < 0.05
    torch.cuda.synchronize(dev)
    (late,) = tr.events()
    assert dict(late.args)["device_ms"] > 10.0


def _train_batch(cfg, B, S, seed):
    gen = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen,
                         dtype=torch.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def test_train_step_on_cuda():
    """Reduced smollm: the f32 loss and gradients on the card equal the
    CPU's at 1e-4; one bf16 AdamW step on the card keeps bf16 parameters
    that do not require grad, f32 moments, and a finite loss."""
    from repro_torch.config import TrainConfig
    from repro_torch.training.optimizer import adamw_init, tree_leaves
    from repro_torch.training.train_loop import grads_of, make_train_step
    dev = _cuda()
    cfg = get_arch("smollm-360m").reduced()
    tc = TrainConfig(warmup_steps=1, total_steps=10)
    model = Model(cfg)
    params = model.init(seed=1, device="cpu")
    batch = _train_batch(cfg, 4, 32, 0)
    cpu = grads_of(model, params, batch, tc)
    gpu = grads_of(model, _to(params, dev), _to(batch, dev), tc)
    torch.testing.assert_close(gpu[0].cpu(), cpu[0], rtol=1e-4, atol=1e-4)
    for a, b in zip(tree_leaves(cpu[2]), tree_leaves(gpu[2])):
        torch.testing.assert_close(b.cpu(), a, rtol=1e-3, atol=1e-4)
    bcfg = dataclasses.replace(cfg, dtype="bfloat16")
    bmodel = Model(bcfg)
    p = bmodel.init(seed=1, device=dev)
    new, opt, m = make_train_step(bmodel, tc)(p, adamw_init(p),
                                              _to(batch, dev))
    assert torch.isfinite(m["loss"]) and int(opt.step) == 1
    for a, b, mu in zip(tree_leaves(p), tree_leaves(new),
                        tree_leaves(opt.mu)):
        assert b.dtype == a.dtype and b.device.type == "cuda"
        assert not b.requires_grad and mu.dtype == torch.float32
    assert any(not torch.equal(a, b) for a, b in
               zip(tree_leaves(p), tree_leaves(new)))


@pytest.mark.parametrize("window", [0, 300])
def test_attend_chunked_matches_full_on_cuda(window):
    """f32 at S = 1100 (pads to 1536 in blocks of 512): the chunked path on
    the card equals ``attend_full`` on the card and itself on the CPU."""
    from repro_torch.models.attention import attend_chunked, attend_full
    dev = _cuda()
    gen = torch.Generator().manual_seed(7)
    q = torch.randn(2, 1100, 2, 3, 64, generator=gen)
    k = torch.randn(2, 1100, 2, 64, generator=gen)
    v = torch.randn(2, 1100, 2, 64, generator=gen)
    got = attend_chunked(q.to(dev), k.to(dev), v.to(dev), causal=True,
                         window=window)
    full = attend_full(q.to(dev), k.to(dev), v.to(dev), causal=True,
                       window=window)
    cpu = attend_chunked(q, k, v, causal=True, window=window)
    torch.testing.assert_close(got, full, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(got.cpu(), cpu, rtol=2e-5, atol=2e-5)


def test_checkpoint_round_trip_on_cuda(tmp_path):
    """bf16 parameters and f32 moments on the card through
    ``save_checkpoint``/``restore_checkpoint``: bit for bit, restored
    onto the template's device."""
    from repro_torch.training.checkpoint import (restore_checkpoint,
                                                 save_checkpoint)
    from repro_torch.training.optimizer import (adamw_init, tree_leaves,
                                                tree_map)
    dev = _cuda()
    cfg = dataclasses.replace(get_arch("whisper-base").reduced(),
                              dtype="bfloat16")
    params = Model(cfg).init(seed=2, device=dev)
    opt = adamw_init(params)
    opt = opt._replace(nu=tree_map(torch.rand_like, opt.nu))
    save_checkpoint(str(tmp_path), params, opt, step=4)
    tmpl = Model(cfg).init(seed=3, device=dev)
    got, gopt, step = restore_checkpoint(str(tmp_path), tmpl,
                                         adamw_init(tmpl))
    assert step == 4
    for a, b in zip(tree_leaves(params), tree_leaves(got)):
        assert b.device.type == "cuda" and b.dtype == torch.bfloat16
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    for a, b in zip(tree_leaves(opt.nu), tree_leaves(gopt.nu)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("B,V,hot", [(2, 49152, "random"), (4, 12288, "all"),
                                     (8, 12288, "random"),
                                     (4, 24576, "none")])
def test_kernels_match_plain_versions_at_rank_shapes(B, V, hot):
    """The shapes a rank gives the kernels on a mesh of four (B = 8): S1's
    whole rows (2, 49152) and the hierarchical plane's (B_loc, V/t)
    blocks; the same contract as at the main shape."""
    test_kernels_match_plain_versions(B, V, hot)


@pytest.mark.parametrize("row0", [0, 2, 6])
def test_gumbel_rows_from_row0_match_the_whole_batch(row0):
    """A rank deciding rows row0..row0+1 of a batch of 8 draws those rows'
    noise: its tokens equal the plain version's with the same ``row0``
    and the whole batch's launch at those rows."""
    dev = _cuda()
    rs = np.random.default_rng(row0)
    z = torch.from_numpy(rs.normal(0, 2, (8, 49152)).astype(np.float32)
                         ).to(dev)
    whole = gumbel_kernel.gumbel_argmax(z, 77)
    part = z[row0:row0 + 2].contiguous()
    got = gumbel_kernel.gumbel_argmax(part, 77, row0)
    assert torch.equal(got, ref.gumbel_argmax_ref(part, 77, row0))
    assert torch.equal(got, whole[row0:row0 + 2])


@pytest.mark.parametrize("arch", ["smollm-360m", "rwkv6-3b"])
def test_tp_forward_on_a_one_rank_mesh_equals_no_mesh(arch):
    """Under a (1, 1) NCCL mesh every leaf ``shard_tree`` cuts is whole
    and the tensor-parallel forward is the forward without a mesh: the
    logits of a prefill and two decode steps are equal bit for bit."""
    import socket

    import torch.distributed as tdist
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import dist
    dev = _cuda()
    cfg = get_arch(arch).reduced()
    model = Model(cfg)
    full = model.init(seed=0, device=dev)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 8))).to(dev)

    def run(p):
        cache = model.init_cache(4, 16, device=dev)
        lg, cache = model.prefill(p, {"tokens": toks}, cache)
        out = [lg]
        for _ in range(2):
            lg, cache = model.decode_step(p, lg.argmax(-1), cache)
            out.append(lg)
        return torch.stack(out)

    want = run(full)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    tdist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0,
        device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        mesh = make_local_mesh(1, 1)
        with dist.use_mesh(mesh):
            got = run(sharding.shard_tree(full, mesh, cfg,
                                          keep=sharding.every_leaf))
    finally:
        tdist.destroy_process_group()
    assert torch.equal(got, want)


def test_real_cuda_tensors_never_take_the_shape_only_path():
    """The kernels' wrappers answer a fake CUDA tensor (the dry-run's
    trace) with empty outputs of their shapes and launch nothing; a real
    CUDA tensor launches each kernel once and matches its plain version."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.core.sampling import SamplingParams
    from repro_torch.kernels import _build, ops
    dev = _cuda()
    B, V = 3, 1000

    def call_all(make):
        # unfiltered rows, no penalties: inside every kernel's contract
        z = make((B, V), torch.float32)
        c = make((B, V), torch.int32) * 0
        hot = torch.arange(V, device=dev) < 128
        one, zero = z[:, 0] * 0 + 1, z[:, 0] * 0
        return (ops.fused_penalty_scale(z, c, c, one, zero, zero, one),
                ops.fused_shvs_masses(z, hot),
                ops.fused_sample(z, c, c, SamplingParams(
                    one, c[:, 0].contiguous(), one, zero, one, zero, zero),
                    one * 0.5,
                    hot, k_cap=64),
                ops.fused_gumbel_argmax(z, 7))

    ops.reset_launch_counts()
    with FakeTensorMode():
        out = call_all(lambda s, dt: torch.zeros(s, dtype=dt, device=dev))
        assert _build.shape_only(out[0])
        assert tuple(out[0].shape) == (B, V)
        assert [tuple(t.shape) for t in out[1]] == [(B,)] * 4
        assert [t.dtype for t in out[2]] == [torch.int32, torch.bool,
                                             torch.float32, torch.int32]
        assert out[3].dtype == torch.int32 and tuple(out[3].shape) == (B,)
    assert all(v == 0 for v in ops.launch_counts().values())
    gen = torch.Generator(device=dev).manual_seed(0)
    real = call_all(lambda s, dt: (torch.randn(s, generator=gen, device=dev)
                                   * 2).to(dt))
    torch.cuda.synchronize()
    assert not _build.shape_only(real[0])
    assert all(v == 1 for v in ops.launch_counts().values())
    z = real[0]
    want = ref.gumbel_argmax_ref(z.cpu(), 7)
    assert torch.equal(ops.fused_gumbel_argmax(z, 7).cpu(), want)


def test_train_program_on_one_rank_nccl_mesh_equals_no_mesh():
    """The train program of reduced smollm-360m on a (1, 1) NCCL mesh: one
    step equals the program without a mesh bit for bit — loss, grad norm,
    and every parameter after the step."""
    import socket

    import torch.distributed as tdist
    from repro_torch.config import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import dist
    from repro_torch.training.optimizer import adamw_init, tree_leaves
    dev = _cuda()
    cfg = get_arch("smollm-360m").reduced()
    full = Model(cfg).init(seed=0, device=dev)
    rs = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rs.integers(0, cfg.vocab_size, (4, 16)))
             .to(dev) for k in ("tokens", "labels")}

    def run(mesh):
        fn, _, ins, _, baxes = steps.make_train_step_program(
            cfg, ShapeConfig("t", 16, 4, "train"), mesh, device=dev)
        with dist.use_mesh(mesh, batch_axes=baxes):
            p, _, b = steps.local_inputs(cfg, (full, None, batch), ins, mesh)
            q, _, met = fn(p, adamw_init(p), b)
        return q, {k: float(v) for k, v in met.items()}

    want, want_m = run(None)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    tdist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0,
        device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        got, got_m = run(make_local_mesh(1, 1))
    finally:
        tdist.destroy_process_group()
    assert got_m == want_m
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                                 tree_leaves(want)))
