"""The port's controllers, sizing model, hot-vocab tools and telemetry
plane against the reference's, on the same inputs (these modules are
numpy and the standard library on both sides, so results are equal
exactly unless a tolerance is stated):

* ``HotSizeController`` and ``DecisionPlaneController`` fed the same
  observation traces — the policy cases of ``tests/test_adaptive.py`` and
  ``tests/test_extensions.py``, NaN-laced traces and closed-loop traces
  that depend on the controller's own H — emit equal actions step for
  step, with equal signals and decision histories;
* ``SizingModel.optimal_h``, ``fit_affine_cost``, ``fit_zipf_s`` and
  ``build_hot_set`` give equal results;
* ``StepTracer``, the Chrome-trace export and ``MetricsRegistry`` give the
  same spans, counters and Prometheus text for the same calls;
* engine level: an adaptive port engine made to switch both ways and
  resize its pool, and an autotuning one, commit the streams of a
  device-only port engine and of the reference engine.
"""
import math

import jax
import numpy as np
import pytest

from repro.config import (ModelConfig as JModelConfig,
                          SamplingConfig as JS, SHVSConfig as JSH)
from repro.core import autotune as jat
from repro.core import hot_vocab as jhv
from repro.core import sizing as jsz
from repro.engine import Engine as JEngine, EngineConfig as JECfg
from repro.engine import Request as JRequest
from repro.models.model import Model as JModel
from repro.obs import export as jexp
from repro.obs import metrics as jmet
from repro.obs import records as jrec
from repro.obs import telemetry as jtel
from repro.obs import tracer as jtr
from repro_torch.config import (ModelConfig as TModelConfig,
                                SamplingConfig as TS, SHVSConfig as TSH)
from repro_torch.core import autotune as tat
from repro_torch.core import hot_vocab as thv
from repro_torch.core import sizing as tsz
from repro_torch.engine.engine import Engine as TEngine, EngineConfig as TECfg
from repro_torch.engine.request import Request as TRequest
from repro_torch.models.bridge import from_jax_params
from repro_torch.obs import export as texp
from repro_torch.obs import metrics as tmet
from repro_torch.obs import records as trec
from repro_torch.obs import telemetry as ttel
from repro_torch.obs import tracer as ttr

NAN = float("nan")


def _same(a, b):
    """Equal, NaN equal to NaN, recursing through dicts and sequences."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and \
            all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return a == b


# -- HotSizeController ------------------------------------------------------

def _hot_open_trace(kind):
    rng = np.random.default_rng(5)
    if kind == "constant":
        return [0.999] * 200
    if kind == "domain_shift":
        return [0.95] * 20 + [0.30] * 60
    if kind == "nan_laced":
        return [NAN if i % 3 == 0 else float(a) for i, a in
                enumerate(rng.uniform(0.5, 0.99, 150))]
    if kind == "all_nan_burst":
        return [NAN] * 40 + [0.9] * 40
    return [float(a) for a in rng.uniform(0.2, 0.999, 300)]


@pytest.mark.parametrize("kind", ["constant", "domain_shift", "nan_laced",
                                  "all_nan_burst", "random"])
def test_hot_size_controller_open_traces_match(kind):
    kw = dict(vocab_size=32768, h_current=1024, adjust_every=2,
              hysteresis=0.05, history_cap=16)
    j, t = jat.HotSizeController(**kw), tat.HotSizeController(**kw)
    moves = 0
    for a in _hot_open_trace(kind):
        got, want = t.observe(a), j.observe(a)
        assert got == want
        moves += got is not None
        assert _same(t._alpha_ewma, j._alpha_ewma) and t._step == j._step
    assert _same(list(t.history), list(j.history))
    assert t.h_current == j.h_current
    if kind in ("constant", "domain_shift", "random"):
        assert moves > 0


@pytest.mark.parametrize("regimes", [((1.15, 200),), ((1.6, 120),
                                                       (1.05, 120))])
def test_hot_size_controller_closed_loop_matches(regimes):
    """Observations computed from each controller's own H: the two-regime
    trace of the EWMA-reset regression and the convergence trace."""
    V = 32768
    kw = dict(vocab_size=V, h_current=8192, adjust_every=2,
              hysteresis=0.25, ewma=0.1)
    j, t = jat.HotSizeController(**kw), tat.HotSizeController(**kw)
    rng = np.random.default_rng(0)
    changes = []
    for s_true, steps in regimes:
        for _ in range(steps):
            noise = rng.normal(0, 0.01)
            obs = [tat.zipf_alpha_curve(V, s_true,
                                        np.asarray([c.h_current]))[0] + noise
                   for c in (j, t)]
            want, got = j.observe(obs[0]), t.observe(obs[1])
            assert got == want
            if got is not None:
                changes.append(got)
    assert changes and t.h_current == j.h_current


# -- DecisionPlaneController --------------------------------------------------

def _trace_repeat(n, **streams):
    return [dict(streams) for _ in range(n)]


def _dpc_cases():
    rng = np.random.default_rng(1)
    osc = [{"queue_depth": 0.0 if (i // 4) % 2 == 0 else 50.0}
           for i in range(200)]
    geo = [{"queue_depth": 0.0,
            "stall_ms": float(rng.choice([0.0, 50.0]))} for _ in range(400)]
    nan_laced = [dict(queue_depth=NAN if i % 3 == 0 else 12.0,
                      queue_delay_ms=NAN,
                      batch=float(rng.choice([NAN, 4.0])), stall_ms=NAN,
                      sampler_ms=NAN, transfer_ms=NAN, bubble_frac=NAN,
                      alpha_mean=NAN) for i in range(64)]
    noisy = [dict(queue_depth=float(q), batch=float(b), stall_ms=float(s),
                  sampler_ms=float(s) * 0.7, transfer_ms=0.1,
                  alpha_mean=float(a))
             for q, b, s, a in zip(rng.uniform(0, 12, 300),
                                   rng.uniform(0, 8, 300),
                                   rng.exponential(2.0, 300),
                                   rng.uniform(0.5, 1.0, 300))]
    return {
        "pressure": (dict(mode="device", dwell=8, adjust_every=2),
                     _trace_repeat(32, queue_depth=10.0)),
        "drained": (dict(mode="host", dwell=8, adjust_every=2),
                    _trace_repeat(32, queue_depth=0.0, batch=3.0)),
        "band_device": (dict(mode="device", queue_low=1.0, queue_high=6.0,
                             dwell=2, adjust_every=2),
                        _trace_repeat(64, queue_depth=3.0)),
        "band_host": (dict(mode="host", queue_low=1.0, queue_high=6.0,
                           dwell=2, adjust_every=2),
                      _trace_repeat(64, queue_depth=3.0)),
        "dwell": (dict(mode="device", dwell=16, adjust_every=1, ewma=1.0),
                  osc),
        "occupancy": (dict(mode="device", occupancy_min=2.0, dwell=2,
                           adjust_every=2),
                      _trace_repeat(32, queue_depth=10.0, batch=0.5) +
                      _trace_repeat(32, queue_depth=10.0, batch=4.0)),
        "pool_grow": (dict(mode="host", samplers=2, max_samplers=8, dwell=4,
                           adjust_every=2, queue_low=-1.0),
                      _trace_repeat(64, stall_ms=50.0, queue_depth=0.0)),
        "pool_shrink": (dict(mode="host", samplers=8, min_samplers=1,
                             dwell=4, adjust_every=2, queue_low=-1.0),
                        _trace_repeat(128, stall_ms=0.0, queue_depth=0.0)),
        "geometric": (dict(mode="host", samplers=2, dwell=1, adjust_every=1,
                           queue_low=-1.0), geo),
        "device_never_resizes": (dict(mode="device", samplers=2, dwell=1,
                                      adjust_every=1, queue_high=1e9),
                                 _trace_repeat(64, queue_depth=5.0,
                                               stall_ms=50.0)),
        "nan_laced": (dict(mode="device", dwell=8, adjust_every=2),
                      nan_laced),
        "all_nan_then_finite": (dict(mode="device", dwell=4, adjust_every=4),
                                _trace_repeat(31, queue_depth=NAN,
                                              stall_ms=NAN) +
                                [dict(queue_depth=40.0)]),
        "history_cap": (dict(mode="host", dwell=0, adjust_every=1,
                             history_cap=8, queue_low=5.0, queue_high=6.0,
                             ewma=1.0),
                        [{"queue_depth": 0.0 if i % 2 else 50.0}
                         for i in range(100)]),
        "hot_sub_policy": (dict(mode="device", adjust_every=1000, hot=True),
                           _trace_repeat(64, alpha_mean=0.999,
                                         queue_depth=3.0)),
        "noisy_all_streams": (dict(mode="device", samplers=2, dwell=6,
                                   adjust_every=3, hot=True), noisy),
    }


_DPC = _dpc_cases()


def _act(a):
    return None if a is None else (a.sampler_mode, a.samplers, a.hot_size)


@pytest.mark.parametrize("name", sorted(_DPC))
def test_decision_plane_controller_traces_match(name):
    kw, trace = _DPC[name]
    kw = dict(kw)
    hot = kw.pop("hot", False)
    mk_hot = lambda m: m.HotSizeController(vocab_size=32768, h_current=8192,
                                           adjust_every=4) if hot else None
    j = jat.DecisionPlaneController(hot=mk_hot(jat), **kw)
    t = tat.DecisionPlaneController(hot=mk_hot(tat), **kw)
    acts = 0
    for obs in trace:
        want, got = _act(j.observe(**obs)), _act(t.observe(**obs))
        assert got == want, (name, obs)
        acts += got is not None
        assert _same(t.signals, j.signals)
    assert (t.mode, t.samplers, t._step) == (j.mode, j.samplers, j._step)
    assert _same(list(t.history), list(j.history))
    if name not in ("band_device", "band_host", "device_never_resizes"):
        assert acts > 0, name


def test_controller_rejects_unknown_streams_and_resets_like_reference():
    for m in (jat, tat):
        ctl = m.DecisionPlaneController()
        with pytest.raises(AssertionError, match="unknown controller"):
            ctl.observe(queue_dept=1.0)
        ctl.observe(queue_depth=3.0)
        ctl.reset()
        assert ctl._step == 0 and ctl.signals["queue_depth"] is None
    assert tat.CONTROLLER_STREAMS == jat.CONTROLLER_STREAMS
    assert not tat.ControllerAction() and tat.ControllerAction(samplers=4)


def test_step_record_streams_match_reference():
    kw = dict(step=3, batch=4, accept_rate=0.5, alpha_mean=0.75,
              fallback_rate=0.0, queue_depth=2.0, queue_delay_ms=NAN,
              stall_ms=1.5, sampler_ms=1.0, transfer_ms=0.25)
    j, t = jrec.StepRecord(**kw), trec.StepRecord(**kw)
    assert _same(t.controller_streams(), j.controller_streams())
    assert _same(t.as_dict(), j.as_dict()) and t.is_host == j.is_host
    a = tat.DecisionPlaneController(queue_high=1.0, adjust_every=1, dwell=0)
    b = jat.DecisionPlaneController(queue_high=1.0, adjust_every=1, dwell=0)
    assert _act(a.observe_record(t)) == _act(b.observe_record(j)) == \
        ("host", None, None)


# -- sizing model and hot-vocab tools ----------------------------------------

@pytest.mark.parametrize("V,s", [(32768, 1.05), (32768, 1.15), (49152, 1.4),
                                 (151936, 2.0), (4096, 1.0)])
def test_sizing_and_zipf_fit_match(V, s):
    hs = np.unique(np.geomspace(256, V, 96).astype(np.int64))
    curve_j = jat.zipf_alpha_curve(V, s, hs)
    curve_t = tat.zipf_alpha_curve(V, s, hs)
    np.testing.assert_array_equal(curve_t, curve_j)
    for H in (512, 2048, V // 3):
        a = float(jat.zipf_alpha_curve(V, s, np.asarray([H]))[0])
        assert tat.fit_zipf_s(V, H, a) == jat.fit_zipf_s(V, H, a)
    times = 3.3e-6 + 1.4e-8 * hs + np.random.default_rng(V).normal(
        0, 1e-7, hs.shape)
    assert tsz.fit_affine_cost(hs, times) == jsz.fit_affine_cost(hs, times)
    mj = jsz.SizingModel.from_measurements(V, hs, times, hs, curve_j)
    mt = tsz.SizingModel.from_measurements(V, hs, times, hs, curve_t)
    assert mt.optimal_h(lo=256) == mj.optimal_h(lo=256)
    np.testing.assert_array_equal(mt.expected_cost(hs), mj.expected_cost(hs))
    np.testing.assert_array_equal(mt.foc_residual(hs), mj.foc_residual(hs))


def test_build_hot_set_matches_reference():
    """Frequency-ranked ids (ties broken the same way) and the mask."""
    V = 2048
    counts = jhv.counts_from_trace(jhv.synthetic_trace(V, 5000, 1.1, seed=2),
                                   V)
    for H in (1, 64, 700, V, V + 5):
        got = thv.build_hot_set(counts, H, V)
        want = jhv.build_hot_set(counts, H, V)
        np.testing.assert_array_equal(got.indices.numpy(),
                                      np.asarray(want.indices))
        np.testing.assert_array_equal(got.mask.numpy(),
                                      np.asarray(want.mask))


# -- telemetry plane -----------------------------------------------------------

def _drive_tracer(m):
    ticks = [0.0]

    def clock():
        ticks[0] += 0.25
        return ticks[0]

    tr = m.StepTracer(capacity=6, enabled=True, clock=clock)
    with tr.span("forward", name="outer", track="engine", step=1):
        with tr.span("commit", name="inner", track="engine"):
            pass
    tr.add("d2h_transfer", 1.0, 1.5, name="fetch[0:4]", track="w0", step=1)
    tr.add("host_sample", 1.5, 1.25, name="sample[0:4]", track="w0")
    tr.instant("decision", name="switch", track="engine",
               sampler_mode="host", samplers=None)
    tr.add("pool_stall", 2.0, 2.5, track="engine")
    tr.add("queue_wait", 0.1, 0.2, name="wait#3", track="engine",
           request_id=3)
    with pytest.raises(ValueError, match="unknown span kind"):
        tr.add("fwrward", 0.0, 1.0)
    off = m.StepTracer(capacity=4, enabled=False)
    with off.span("forward"):
        off.instant("decision")
    assert len(off) == 0 and off.span("commit") is m.NULL_SPAN
    return tr


def test_tracer_and_chrome_trace_match_reference():
    j, t = _drive_tracer(jtr), _drive_tracer(ttr)
    assert [tuple(e) for e in t.events()] == [tuple(e) for e in j.events()]
    assert len(t) == len(j) == 6            # the ring evicted the oldest
    other_j, other_t = jtr.StepTracer(), ttr.StepTracer()
    other_j.add("forward", 0.5, 0.75, track="t")
    other_t.add("forward", 0.5, 0.75, track="t")
    assert [tuple(e) for e in ttr.merge_events([t, other_t])] == \
        [tuple(e) for e in jtr.merge_events([j, other_j])]
    assert texp.chrome_trace([("engine", t), ("gw", other_t)]) == \
        jexp.chrome_trace([("engine", j), ("gw", other_j)])
    # the port adds its own kinds; every kind of the reference stays
    assert jtr.SPAN_KINDS < ttr.SPAN_KINDS
    assert ttr.SPAN_KINDS - jtr.SPAN_KINDS == {
        "dispatch", "fetch_wait", "device_sample", "moe_route", "mamba"}


def _drive_registry(m):
    reg = m.MetricsRegistry()
    reg.counter("steps_total", "steps").inc(3)
    reg.counter("reqs_total", "reqs", status="ok").inc()
    reg.counter("reqs_total", "reqs", status="busy").inc(2)
    reg.gauge("queue_depth", "queued").set(7)
    h = reg.histogram("stall_ms", "stall", buckets=(1.0, 10.0))
    for v in (0.5, 5.0, NAN, 50.0, float("inf")):
        h.observe(v)
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("steps_total", "x")
    return reg


def test_metrics_registry_text_matches_reference():
    j, t = _drive_registry(jmet), _drive_registry(tmet)
    assert t.render() == j.render()
    other_j, other_t = jmet.MetricsRegistry(), tmet.MetricsRegistry()
    other_j.counter("steps_total", "steps").inc(5)
    other_t.counter("steps_total", "steps").inc(5)
    assert tmet.render_registries([({"replica": "r0"}, t),
                                   ({"replica": "r1"}, other_t)]) == \
        jmet.render_registries([({"replica": "r0"}, j),
                                ({"replica": "r1"}, other_j)])
    assert tmet.DEFAULT_MS_BUCKETS == jmet.DEFAULT_MS_BUCKETS


def test_engine_metrics_samples_match_reference():
    """The same step records folded into each package's EngineMetrics give
    the same samples (help texts may word the port's copy differently).
    The port's CUDA-graph counters (``engine/step_graph.py``) have no
    counterpart in the reference: they are held apart, and read 0 on step
    records alone."""
    port_only = ("engine_decode_graph_replays_total",
                 "engine_decode_graph_captures_total")
    recs = [dict(step=i, batch=3, accept_rate=0.5, alpha_mean=0.8,
                 fallback_rate=0.0, queue_depth=float(i % 4),
                 queue_delay_ms=NAN if i % 5 == 0 else 2.0 * i,
                 **({"stall_ms": 0.1 * i, "sampler_ms": 1.0 + i,
                     "transfer_ms": 0.5} if i % 2 else {}))
            for i in range(12)]
    texts = []
    for rec_mod, tel_mod in ((jrec, jtel), (trec, ttel)):
        tel = tel_mod.Telemetry()
        em = tel_mod.EngineMetrics(tel.metrics)
        em.mode_host.set(1.0)
        for r in recs:
            em.observe_step(rec_mod.StepRecord(**r))
        assert not tel.tracer.enabled
        texts.append([ln for ln in tel.metrics.render().splitlines()
                      if not ln.startswith("# HELP")])
    ours = [ln for ln in texts[1] if any(n in ln for n in port_only)]
    assert ours == [ln for n in sorted(port_only)
                    for ln in (f"# TYPE {n} counter", f"{n} 0.0")]
    assert [ln for ln in texts[1] if ln not in ours] == texts[0]


# -- engine level ----------------------------------------------------------------

MODEL = dict(name="adaptive-tiny", family="dense", num_layers=2, d_model=64,
             num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=512,
             dtype="float32")
ENGINE = dict(max_batch=3, max_seq_len=64, algorithm="shvs", k_cap=64,
              prompt_bucket=8)


@pytest.fixture(scope="module")
def model():
    jcfg = JModelConfig(**MODEL)
    jp = JModel(jcfg).init(jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp))
    return jcfg, jp, TModelConfig(**MODEL), tp


def _reqs(Request, Sampling, n=8, max_new=(4, 9)):
    rng = np.random.default_rng(3)
    return [Request(
        request_id=i,
        prompt=rng.integers(1, MODEL["vocab_size"],
                            int(rng.integers(3, 10))).tolist(),
        max_new_tokens=int(rng.integers(*max_new)),
        sampling=Sampling(temperature=0.9, top_k=30, top_p=0.95,
                          repetition_penalty=1.1, seed=100 + i))
        for i in range(n)]


def _port(model, mode, tweak=None, reqs=None, **kw):
    _, _, tcfg, tp = model
    eng = TEngine(tcfg, tp, TECfg(sampler_mode=mode, shvs=TSH(hot_size=64),
                                  **dict(ENGINE, **kw)), device="cpu",
                  **({} if tweak is None else tweak[0]))
    if tweak is not None and tweak[1] is not None:
        tweak[1](eng)
    reqs = reqs if reqs is not None else _reqs(TRequest, TS)
    eng.submit(reqs)
    done = eng.run(max_steps=4000)
    assert len(done) == len(reqs)
    log = list(eng.stats_log)
    eng.close()
    return {r.request_id: (r.output, r.finish_reason) for r in reqs}, log


@pytest.fixture(scope="module")
def device_streams(model):
    jcfg, jp, _, _ = model
    eng = JEngine(jcfg, jp, JECfg(shvs=JSH(hot_size=64), **ENGINE))
    reqs = _reqs(JRequest, JS)
    eng.submit(reqs)
    eng.run(max_steps=4000)
    eng.close()
    ref = {r.request_id: (r.output, r.finish_reason) for r in reqs}
    assert _port(model, "device")[0] == ref
    return ref


@pytest.mark.parametrize("overlap", [True, False])
def test_adaptive_engine_matches_device_engine(model, device_streams,
                                               overlap):
    """The controller made to flip placement both ways and grow the pool
    mid-run commits the device-only streams."""
    def force(eng):
        eng._dpc.adjust_every = 2
        eng._dpc.dwell = 2
        eng._dpc.queue_high = -1.0       # device -> host at once...
        eng._dpc.queue_low = 99.0        # ...and straight back
        eng._dpc.stall_grow_ms = -1.0    # and grow the pool on any stall

    got, log = _port(model, "adaptive", tweak=({}, force), overlap=overlap)
    switched = [r["sampler_mode"] for r in log if "sampler_mode" in r]
    assert "host" in switched and "device" in switched, switched
    assert any("samplers" in r for r in log)
    assert got == device_streams


@pytest.mark.parametrize("mode", ["device", "host"])
def test_autotune_engine_moves_h_and_keeps_streams(model, mode):
    """``autotune=True``: the hot set is rebuilt mid-run from
    ``hot_counts`` (in host mode after joining the in-flight shards). The
    H moves and the streams equal the reference engine's."""
    counts = np.arange(MODEL["vocab_size"])[::-1].astype(np.int64)

    def fast(eng):
        eng._controller.adjust_every = 4
        eng._controller.min_h = 16

    reqs = lambda R, S: _reqs(R, S, n=6, max_new=(12, 16))
    got, log = _port(model, mode, tweak=(dict(hot_counts=counts,
                                              autotune=True), fast),
                     reqs=reqs(TRequest, TS))
    moves = [r.hot_size for r in log if r.hot_size is not None]
    assert moves, "the controller never moved H"
    jcfg, jp, _, _ = model
    eng = JEngine(jcfg, jp, JECfg(sampler_mode=mode, shvs=JSH(hot_size=64),
                                  **ENGINE), hot_counts=counts,
                  autotune=True)
    eng._controller.adjust_every = 4
    eng._controller.min_h = 16
    jr = reqs(JRequest, JS)
    eng.submit(jr)
    eng.run(max_steps=4000)
    eng.close()
    assert [r.hot_size for r in eng.stats_log if r.hot_size is not None] \
        == moves
    assert {r.request_id: (r.output, r.finish_reason) for r in jr} == got
