"""Host placement of the port's decision plane against the reference's,
on the CPU: ``Engine(sampler_mode="host")`` (the sampler pool), the
decision-plane client and the pool itself.

A reduced f32 model (2 layers, d_model 64, V = 512) takes the reference's
``Model.init`` weights through ``models/bridge.py``. Requests, sampling
contracts and engine settings are the same on both sides. What must hold,
exactly (tokens and finish reasons equal, no tolerance):

* port host ≡ port device ≡ the reference's host engine, overlapped and
  sequential, contiguous and paged cache, at 1, 2 and 4 workers, with
  chunked prefill, through preemption and resume, for seeded, greedy,
  biased and stop-sequence contracts, and across mid-generation switches;
* the port's pool ≡ the reference's pool on the same inputs, backend by
  backend (tokens and histograms equal; pooled stats within 1e-6);
* the pool's timing split and active-row weighting, as
  ``tests/test_host_sampler.py`` holds the reference's.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import (ModelConfig as JModelConfig,
                          SamplingConfig as JS, SHVSConfig as JSH)
from repro.core import penalties as jpen
from repro.core.decision_plane import DecisionPlane as JPlane
from repro.core.host_sampler import HostSamplerPool as JPool
from repro.core.sampling import SamplingParams as JParams
from repro.engine import Engine as JEngine, EngineConfig as JECfg
from repro.engine import Request as JRequest
from repro.models.model import Model as JModel
from repro_torch.config import (ModelConfig as TModelConfig,
                                SamplingConfig as TS, SHVSConfig as TSH)
from repro_torch.core import penalties as tpen
from repro_torch.core.autotune import HotSizeController
from repro_torch.core.decision_plane import DecisionPlane as TPlane
from repro_torch.core.host_sampler import (HostSamplerPool, _pool_stats,
                                           _ShardResult)
from repro_torch.core.sampling import SamplingParams as TParams
from repro_torch.engine.decision_client import canonical_sampler_mode
from repro_torch.engine.engine import Engine as TEngine, EngineConfig as TECfg
from repro_torch.engine.request import Request as TRequest
from repro_torch.models.bridge import from_jax_params

MODEL = dict(name="host-tiny", family="dense", num_layers=2, d_model=64,
             num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=512,
             dtype="float32")
ENGINE = dict(max_batch=3, max_seq_len=64, algorithm="shvs", k_cap=64,
              prompt_bucket=8, block_size=8)


@pytest.fixture(scope="module")
def model():
    jcfg = JModelConfig(**MODEL)
    jp = JModel(jcfg).init(jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp))
    return jcfg, jp, TModelConfig(**MODEL), tp


def _reqs(Request, Sampling, n=9, seed=0, max_new=6, **skw):
    """Heterogeneous lengths: slot churn and staggered retirement, the
    cases where the host path's commit lag could diverge."""
    rng = np.random.default_rng(seed)
    return [Request(
        request_id=i,
        prompt=rng.integers(1, MODEL["vocab_size"],
                            int(rng.integers(3, 12))).tolist(),
        max_new_tokens=int(rng.integers(2, max_new + 1)),
        sampling=Sampling(temperature=0.9, top_k=30, top_p=0.95,
                          repetition_penalty=1.1, **skw))
        for i in range(n)]


def _long_reqs(Request, Sampling):
    """Long generations on a small pool: decode growth preempts."""
    rng = np.random.default_rng(7)
    return [Request(
        request_id=i,
        prompt=rng.integers(1, MODEL["vocab_size"],
                            int(rng.integers(4, 9))).tolist(),
        max_new_tokens=40,
        sampling=Sampling(temperature=0.9, top_k=30, top_p=0.95,
                          repetition_penalty=1.1))
        for i in range(5)]


def _contract_reqs(Request, Sampling, kind):
    base = _reqs(Request, Sampling, n=6, seed=3)
    skw = {"seed": dict(seed=100), "greedy": dict(greedy=True),
           "bias": dict(logit_bias={9: 0.5, 11: -2.0, 300: 1.5}),
           # mid-stream stops of requests 0 and 3, eos of request 2
           "stop": dict(stop_sequences=((493,), (230, 434)))}[kind]
    return [Request(r.request_id, list(r.prompt), r.max_new_tokens,
                    Sampling(temperature=0.9, top_k=30, **skw),
                    eos_token=112 if kind == "stop" else None)
            for r in base]


def _streams(reqs):
    return {r.request_id: (list(r.output), r.finish_reason) for r in reqs}


def _jax_run(model, reqs, max_steps=4000, **kw):
    jcfg, jp, _, _ = model
    eng = JEngine(jcfg, jp, JECfg(shvs=JSH(hot_size=64),
                                  **dict(ENGINE, **kw)))
    eng.submit(reqs)
    done = eng.run(max_steps=max_steps)
    eng.close()
    assert len(done) == len(reqs)
    return _streams(reqs)


def _engine(model, **kw):
    _, _, tcfg, tp = model
    return TEngine(tcfg, tp, TECfg(shvs=TSH(hot_size=64),
                                   **dict(ENGINE, **kw)), device="cpu")


def _run(model, reqs=None, max_steps=4000, **kw):
    eng = _engine(model, **kw)
    reqs = reqs if reqs is not None else _reqs(TRequest, TS)
    eng.submit(reqs)
    done = eng.run(max_steps=max_steps)
    assert len(done) == len(reqs), f"{len(done)}/{len(reqs)} finished"
    assert eng.in_flight == 0
    eng.close()
    return _streams(reqs), eng


@pytest.fixture(scope="module")
def reference(model):
    """The reference's host engine on the default batch, and the port's
    device mode held to it before any host comparison."""
    ref = _jax_run(model, _reqs(JRequest, JS), sampler_mode="host")
    assert _run(model)[0] == ref
    return ref


@pytest.fixture(scope="module")
def jax_streams(model):
    """The reference's host-engine streams by batch name, each run once."""
    cache = {}

    def get(name, **kw):
        if name not in cache:
            reqs = _long_reqs(JRequest, JS) if name == "long" else \
                _contract_reqs(JRequest, JS, name)
            cache[name] = _jax_run(model, reqs, sampler_mode="host", **kw)
        return cache[name]
    return get


# -- the engine: host ≡ device ≡ the reference's host engine -------------

@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("cache", ["contiguous", "paged"])
def test_host_matches_device_and_reference(model, reference, overlap,
                                           cache):
    got, eng = _run(model, sampler_mode="host", overlap=overlap,
                    cache=cache)
    assert eng.client.is_host and eng.pstate.prompt_counts.device.type == \
        "cpu"
    assert got == reference
    assert _run(model, overlap=overlap, cache=cache)[0] == reference


@pytest.mark.parametrize("workers", [1, 2, 4])
def test_worker_count_invariance(model, reference, workers):
    """Row shards of 3, 2+1 and 1+1+1: sharding is row-local (S1)."""
    got, eng = _run(model, sampler_mode="host", samplers=workers)
    assert eng.client.pool.num_workers == workers
    assert got == reference


def test_chunked_prefill_composes_with_host_mode(model):
    """Chunk finishers draw their first token on the device while decode
    sampling runs in the pool; their histogram rows cross both ways."""
    ref = _jax_run(model, _reqs(JRequest, JS), sampler_mode="host",
                   prompt_chunk=4)
    for mode in ("host", "device"):
        got, _ = _run(model, sampler_mode=mode, prompt_chunk=4)
        assert got == ref, mode


@pytest.mark.parametrize("overlap", [True, False])
def test_preemption_resume_under_host_mode(model, jax_streams, overlap):
    """Victims are evicted, re-prefilled and continue their streams."""
    ref = jax_streams("long")
    got, eng = _run(model, reqs=_long_reqs(TRequest, TS),
                    sampler_mode="host", overlap=overlap, cache="paged",
                    num_blocks=8)
    assert eng.scheduler.preemptions > 0, "pool was meant to exhaust mid-run"
    assert got == ref
    assert eng.alloc.num_free == eng.pcfg.num_blocks


@pytest.mark.parametrize("kind", ["seed", "greedy", "bias", "stop"])
def test_per_request_contracts_through_host_mode(model, jax_streams, kind):
    ref = jax_streams(kind)
    for mode in ("host", "device"):
        got, _ = _run(model, reqs=_contract_reqs(TRequest, TS, kind),
                      sampler_mode=mode)
        assert got == ref, mode
    if kind == "stop":
        assert [ref[i][1] for i in (0, 2, 3)] == ["stop", "eos", "stop"]


def test_host_stats_report_pool_decomposition(model):
    """Host-mode records carry commit stall, CPU sampling and transfer as
    separate fields; device-mode records do not."""
    _, host = _run(model, sampler_mode="host")
    decodes = [s for s in host.stats_log if "stall_ms" in s]
    assert decodes, "host mode logged no pool-backed steps"
    for s in decodes:
        assert s["sampler_ms"] > 0.0
        assert s["transfer_ms"] >= 0.0 and s["stall_ms"] >= 0.0
    _, dev = _run(model)
    assert all("stall_ms" not in s for s in dev.stats_log)


def test_generate_stream_host_matches_run(model, reference):
    eng = _engine(model, sampler_mode="host")
    streams, finishes = {}, {}
    for ev in eng.generate(_reqs(TRequest, TS), max_steps=2000):
        if ev.token is not None:
            streams.setdefault(ev.request_id, []).append(ev.token)
        if ev.finish_reason is not None:
            finishes[ev.request_id] = ev.finish_reason
    eng.close()
    assert {i: (streams[i], finishes[i]) for i in streams} == reference


def test_abandoned_generate_flushes_in_flight(model):
    eng = _engine(model, sampler_mode="host")
    gen = eng.generate(_reqs(TRequest, TS), max_steps=2000)
    next(gen)                       # start streaming, then abandon
    gen.close()
    assert eng.in_flight == 0, "abandoned stream left a ticket in flight"
    eng.close()
    assert eng.client.pool._ex is None


def test_engine_close_shuts_down_pool(model):
    _, eng = _run(model, reqs=_reqs(TRequest, TS, n=3), sampler_mode="host")
    assert eng.client.pool._ex is None, "close() left pool threads running"
    with pytest.raises(RuntimeError, match="closed"):
        eng.client.pool.submit(torch.zeros(1, 512), None, None, None,
                               None, None, 0, None)
    _, dev = _run(model, reqs=_reqs(TRequest, TS, n=3))
    assert dev.client.pool._ex is None   # device mode never starts it


def test_sampler_mode_names(model):
    assert canonical_sampler_mode("device") == "device"
    assert canonical_sampler_mode("baseline") == "device"
    assert canonical_sampler_mode("host") == "host"
    assert canonical_sampler_mode("disaggregated") == "host"
    with pytest.raises(ValueError, match="sampler_mode"):
        canonical_sampler_mode("gpu")
    with pytest.raises(ValueError, match="sampler_mode"):
        _engine(model, sampler_mode="sidecar")


def test_set_mode_drains_before_reroute(model):
    eng = _engine(model, sampler_mode="host")
    eng.submit(_reqs(TRequest, TS, n=2))
    eng.step()                       # dispatch: a ticket is now in flight
    assert eng.client._tickets, "host step left no outstanding ticket"
    assert eng.client.set_mode("host") is False      # no-op keeps tickets
    assert eng.client.set_mode("device") is True
    assert eng.client._tickets == [], "switch left tickets outstanding"
    assert eng.client.mode == "device"
    assert eng.client.set_mode("disaggregated") is True   # legacy spelling
    assert eng.client.is_host
    eng.run(max_steps=2000)
    eng.close()


def test_resize_pool_recycles_executor(model):
    eng = _engine(model, sampler_mode="host", samplers=2)
    eng.submit(_reqs(TRequest, TS, n=3))
    eng.step()
    assert eng.client.pool._ex is not None
    eng.client.resize_pool(4)
    assert eng.client.pool.num_workers == 4
    assert eng.client.pool._ex is None, "resize must recycle the executor"
    eng.client.resize_pool(4)        # same width: nothing to recycle
    assert len(eng.run(max_steps=2000)) == 3
    eng.close()


def _run_switching(model, reqs, every=3, **kw):
    """Toggle device <-> host every ``every`` committed steps."""
    eng = _engine(model, **kw)
    eng.submit(reqs)
    steps, homes = 0, set()
    while eng.scheduler.has_work or eng.in_flight:
        eng.step()
        steps += 1
        assert steps < 4000, "switching run did not finish"
        if steps % every == 0:
            eng.set_sampler_mode(
                "host" if eng.client.mode == "device" else "device")
            homes.add((eng.client.mode, eng._pstate_home.type))
    eng.flush()
    assert len(eng.scheduler.finished) == len(reqs)
    eng.close()
    assert ("host", "cpu") in homes and ("device", "cpu") in homes
    return _streams(reqs)


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("cache", ["contiguous", "paged"])
def test_mid_generation_switch_bit_identical(model, reference, overlap,
                                             cache):
    got = _run_switching(model, _reqs(TRequest, TS), overlap=overlap,
                         cache=cache)
    assert got == reference


@pytest.mark.parametrize("kind", ["seed", "greedy"])
def test_mid_generation_switch_seeded_and_greedy(model, jax_streams, kind):
    ref = jax_streams(kind)
    got = _run_switching(model, _contract_reqs(TRequest, TS, kind), every=2)
    assert got == ref


# -- the pool against the reference's pool --------------------------------

B, V = 8, 512
_CORE = ("temperature", "top_k", "top_p", "min_p", "repetition_penalty",
         "presence_penalty", "frequency_penalty")


def _pool_case(seed=0, active=None):
    rs = np.random.default_rng(seed)
    return dict(
        logits=rs.normal(0, 1.5, (B, V)).astype(np.float32),
        cp=(rs.integers(0, 3, (B, V)) * (rs.random((B, V)) < 0.05)
            ).astype(np.int32),
        co=(rs.integers(0, 3, (B, V)) * (rs.random((B, V)) < 0.05)
            ).astype(np.int32),
        temperature=np.float32([0.8, 0.0, 1.0, 0.7, 1.2, 0.0, 0.9, 1.0]),
        top_k=np.int32([40, 0, 1, 0, 0, 5, 0, 1]),
        top_p=np.float32([0.95, 1.0, 1.0, 0.9, 1.0, 1.0, 1.0, 0.5]),
        min_p=np.float32([0.0, 0.0, 0.0, 0.0, 0.05, 0.0, 0.0, 0.0]),
        repetition_penalty=rs.uniform(1.0, 1.5, B).astype(np.float32),
        presence_penalty=rs.uniform(0, 0.5, B).astype(np.float32),
        frequency_penalty=rs.uniform(0, 0.3, B).astype(np.float32),
        seed=rs.integers(0, 2 ** 32, B, dtype=np.uint64).astype(np.uint32),
        use_seed=rs.random(B) < 0.5,
        bias=(rs.normal(0, 1, (B, V)) * (rs.random((B, V)) < 0.02)
              ).astype(np.float32),
        nonces=rs.integers(0, 1000, B).astype(np.uint32),
        pos=rs.integers(0, 64, B).astype(np.int32),
        active=np.array([1, 1, 1, 0, 1, 1, 1, 1], bool) if active is None
        else np.asarray(active, bool))


def _port_args(c):
    t = lambda k: torch.from_numpy(np.array(c[k], copy=True))
    params = TParams(*[t(k) for k in _CORE], seed=c["seed"].copy(),
                     use_seed=c["use_seed"].copy())
    return (t("logits"), tpen.PenaltyState(t("cp"), t("co")), params,
            t("bias"), c["nonces"].copy(), c["pos"].copy(), 5,
            c["active"].copy())


def _jax_args(c):
    params = JParams(*[jnp.asarray(c[k]) for k in _CORE],
                     seed=jnp.asarray(c["seed"]),
                     use_seed=jnp.asarray(c["use_seed"]))
    return (jnp.asarray(c["logits"]),
            jpen.PenaltyState(jnp.asarray(c["cp"]), jnp.asarray(c["co"])),
            params, jnp.asarray(c["bias"]), c["nonces"].copy(),
            c["pos"].copy(), 5, c["active"].copy())


@pytest.mark.parametrize("algorithm", ["reference", "truncation_first",
                                       "shvs", "fused", "gumbel"])
def test_pool_matches_reference_pool(algorithm):
    """Tokens and histograms equal; pooled stats (active-row weighted
    means of f32 values) within rtol 1e-6. Both pools run 2 workers: the
    ``gumbel`` backend keys its noise on the row's index in its operand,
    so its draws depend on the shard layout (the reference's contract
    excludes it from cross-mode identity); for the others the full-width
    draw on the calling thread equals the sharded one."""
    c = _pool_case(seed=len(algorithm))
    jpool = JPool(JPlane(V, algorithm=algorithm, shvs=JSH(hot_size=128),
                         k_cap=64, seed=3), 2)
    tpool = HostSamplerPool(TPlane(V, algorithm=algorithm,
                                   shvs=TSH(hot_size=128), k_cap=64, seed=3,
                                   device="cpu"), 2)
    try:
        want = jpool.submit(*_jax_args(c)).result()
        got = tpool.submit(*_port_args(c)).result()
        sync = tpool.sample_sync(*_port_args(c))
    finally:
        jpool.close()
        tpool.close()
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    if algorithm != "gumbel":
        np.testing.assert_array_equal(sync.tokens, got.tokens)
    for g, w in zip(got.state, want.state):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for k in ("accept_rate", "alpha_mean", "fallback_rate"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k),
                                   rtol=1e-6)
    assert got.active_rows == want.active_rows == 7
    assert got.tokens[3] == 0            # inactive row


def test_pool_backend_override_and_refresh_follow_the_plane():
    """The workers' CPU plane is a clone of the engine's plane with the
    override's backend, rebuilt by ``refresh`` after a hot-set swap."""
    from repro_torch.core.hot_vocab import build_hot_set
    plane = TPlane(V, algorithm="shvs", shvs=TSH(hot_size=64), k_cap=64,
                   seed=3, device="cpu")
    pool = HostSamplerPool(plane, 2, backend_override="fused")
    try:
        before = pool.cpu_plane
        assert before.algorithm == "fused" and before.seed == 3
        assert torch.equal(before.hot_set.mask, plane.hot_set.mask)
        plane.hot_set = build_hot_set(np.arange(V), 32, V)
        pool.refresh()
        assert pool.cpu_plane is not before
        assert pool.cpu_plane.hot_set.indices.tolist() == \
            list(range(V - 32, V))
    finally:
        pool.close()


# -- timing split and active-row weighting (tests/test_host_sampler.py) ---

def _small_pool(workers=2):
    return HostSamplerPool(TPlane(64, algorithm="reference", k_cap=32,
                                  seed=0, device="cpu"), workers)


def _small_inputs(active=None):
    rs = np.random.default_rng(0)
    Bs, Vs = 8, 64
    logits = torch.from_numpy(rs.normal(0, 2, (Bs, Vs)).astype(np.float32))
    state = tpen.PenaltyState(torch.zeros((Bs, Vs), dtype=torch.int32),
                              torch.zeros((Bs, Vs), dtype=torch.int32))
    f = lambda v, dt: torch.full((Bs,), v, dtype=dt)
    params = TParams(f(0.9, torch.float32), f(16, torch.int32),
                     f(1.0, torch.float32), f(0.0, torch.float32),
                     f(1.0, torch.float32), f(0.0, torch.float32),
                     f(0.0, torch.float32), np.zeros(Bs, np.uint32),
                     np.zeros(Bs, bool))
    active = np.ones((Bs,), bool) if active is None else active
    return (logits, state, params, None, np.arange(Bs, dtype=np.uint32),
            np.zeros((Bs,), np.int32), 0, np.asarray(active, bool))


def test_sampler_time_excludes_delayed_fetch():
    """A wait on the logits (injected at the ``_fetch`` seam) lands in
    ``transfer_time``, never in ``sampler_time``."""
    pool = _small_pool()
    delay = 0.15
    orig = pool._fetch

    def slow_fetch(logits, lo, hi):
        time.sleep(delay)          # stand-in for in-flight device work
        return orig(logits, lo, hi)

    try:
        args = _small_inputs()
        pool.submit(*args).result()
        pool._fetch = slow_fetch
        res = pool.submit(*args).result()
    finally:
        pool.close()
    assert res.transfer_time >= delay, res
    assert res.sampler_time < delay, res


def test_sync_and_async_report_both_components():
    pool = _small_pool(workers=3)
    try:
        args = _small_inputs()
        for res in (pool.sample_sync(*args), pool.submit(*args).result()):
            assert res.transfer_time >= 0.0 and res.sampler_time > 0.0
            assert res.active_rows == 8
    finally:
        pool.close()


def _shard(stats, rows):
    z = torch.zeros((4, 8), dtype=torch.int32)
    return _ShardResult(tokens=np.zeros((4,), np.int32),
                        state=tpen.PenaltyState(z, z), stats=stats,
                        active_rows=rows, transfer_time=0.0,
                        sampler_time=1e-4)


@pytest.mark.parametrize("parts,want", [
    ([((1.0, 1.0, 0.0), 4), ((0.0, 0.5, 1.0), 1)], (0.8, 0.9, 0.2)),
    ([((0.25, 0.5, 0.75), 3), ((float("nan"),) * 3, 0)], (0.25, 0.5, 0.75)),
    ([((float("nan"),) * 3, 0)], (float("nan"),) * 3)])
def test_pool_stats_weight_active_rows(parts, want):
    """Weights are active rows, not shard width; a zero-active shard
    carries no weight even when NaN; all inactive is NaN, which the
    autotuner ignores (rtol 1e-12: float64 means of exact inputs)."""
    stats = _pool_stats([_shard(s, n) for s, n in parts])
    got = (stats["accept_rate"], stats["alpha_mean"], stats["fallback_rate"])
    np.testing.assert_allclose(got, want, rtol=1e-12)
    if np.isnan(want[0]):
        ctl = HotSizeController(vocab_size=1024, h_current=256)
        assert ctl.observe(stats["alpha_mean"]) is None
        assert ctl._alpha_ewma is None


def test_pool_end_to_end_matches_active_weighting():
    """Second shard fully drained: pooled stats are the first shard's and
    finite, and sharded tokens equal the full-width draw's."""
    pool = _small_pool(workers=2)
    try:
        active = np.zeros((8,), bool)
        active[:4] = True
        res = pool.submit(*_small_inputs(active)).result()
        full = pool.sample_sync(*_small_inputs(active))
    finally:
        pool.close()
    assert res.active_rows == 4
    assert all(np.isfinite(v) for v in (res.accept_rate, res.alpha_mean,
                                         res.fallback_rate))
    np.testing.assert_array_equal(res.tokens, full.tokens)


@pytest.mark.parametrize("mode", ["host", "adaptive"])
def test_serve_driver_host_modes_on_cpu(mode, tmp_path):
    """The serve driver's host placement flags run to the end on the CPU
    and print the pool's report (and, adaptive, the controller's)."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    trace = tmp_path / "trace.json"
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--device", "cpu", "--sampler-mode", mode, "--samplers", "2",
         "--requests", "12", "--max-new", "6", "--trace-out", str(trace)],
        env=dict(os.environ, PYTHONPATH=str(root / "src")),
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "served 12 requests, 72 tokens" in res.stdout
    assert "host sampler pool: commit_stall=" in res.stdout
    if mode == "host":
        assert "n/a" not in res.stdout
    else:
        assert "adaptive controller:" in res.stdout
    assert trace.exists() and "traceEvents" in trace.read_text()


def test_pool_stress_more_workers_than_cores():
    """More workers than cores, several tickets in flight at once and a
    short switch interval: every ticket assembles the full-width draw's
    tokens and histograms (the shards share only read-only inputs)."""
    import os
    import sys
    workers = 2 * (os.cpu_count() or 2)
    B = 2 * workers
    rs = np.random.default_rng(9)
    plane = TPlane(V, algorithm="shvs", shvs=TSH(hot_size=64), k_cap=32,
                   seed=1, device="cpu")
    pool = HostSamplerPool(plane, workers)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        cases = []
        for i in range(4):
            c = _pool_case(seed=i)
            rows = rs.integers(0, 8, B)     # B rows drawn from the 8 rows
            c = {k: (v[rows] if isinstance(v, np.ndarray) and v.ndim and
                     v.shape[0] == 8 else v) for k, v in c.items()}
            cases.append(c)
        tickets = [pool.submit(*_port_args(c)) for c in cases]
        results = [t.result() for t in tickets]
        fulls = [pool.sample_sync(*_port_args(c)) for c in cases]
    finally:
        sys.setswitchinterval(old)
        pool.close()
    assert pool._ex is None
    for got, want in zip(results, fulls):
        np.testing.assert_array_equal(got.tokens, want.tokens)
        for g, w in zip(got.state, want.state):
            assert torch.equal(g, w)
