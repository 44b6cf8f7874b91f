"""The port's own spans (``obs/tracer.py``): device-timed spans, the
thread's current tracer, and the engine's ``dispatch``, ``fetch_wait``,
``device_sample`` and ``moe_route`` spans on a tiny MoE and a tiny
RWKV-6 — and tracing as a pure observer: the committed tokens are the
same with the tracer on and off (the twin of ``test_obs_identity.py``).
"""
import threading

import pytest
import torch

from repro_torch.config import SHVSConfig, get_arch
from repro_torch.engine.engine import Engine, EngineConfig
from repro_torch.launch.serve import synth_requests
from repro_torch.models.model import Model
from repro_torch.obs import NULL_SPAN, NULL_TRACER, StepTracer, Telemetry
from repro_torch.obs import tracer as obs_tracer

CPU = torch.device("cpu")


# -- the tracer ------------------------------------------------------------------

def test_device_span_on_the_cpu_is_a_host_span():
    tr = StepTracer()
    with tr.span("moe_route", device=CPU, pairs=8):
        pass
    (e,) = tr.events()
    assert type(e) is obs_tracer.SpanEvent
    assert dict(e.args) == {"pairs": 8} and e.dur >= 0.0


@pytest.mark.parametrize("device", [CPU, torch.device("cuda")])
def test_disabled_tracer_returns_null_span_for_device_spans(device):
    off = StepTracer(enabled=False)
    assert off.span("dispatch", device=device, step=0, rows=1) is NULL_SPAN
    with off.span("device_sample", device=device, program="decode"):
        pass
    assert len(off) == 0


class _Mark:
    """A stand-in CUDA event: done once ``clock`` reaches ``at``."""

    def __init__(self, clock, at, t_ms):
        self.clock, self.at, self.t_ms = clock, at, t_ms

    def query(self):
        return self.clock[0] >= self.at

    def elapsed_time(self, end):
        assert self.query() and end.query(), "read before completion"
        return end.t_ms - self.t_ms


def test_device_ms_resolves_only_once_the_end_event_completes():
    clock = [0]
    tr = StepTracer()
    tr.add("forward", 0.0, 1.0, step=0)
    tr._record_timed("dispatch", None, 1.0, 1.5, None, {"step": 1},
                     _Mark(clock, 1, 2.0), _Mark(clock, 2, 9.5))
    before = tr.events()
    assert "device_ms" not in dict(before[1].args)
    clock[0] = 2
    after = tr.events()
    assert dict(after[1].args) == {"step": 1, "device_ms": 7.5}
    assert after[0] == before[0]
    assert tr.events()[1] is after[1]          # resolved once, then kept


def test_unknown_kind_is_refused_for_device_spans_too():
    tr = StepTracer()
    with pytest.raises(ValueError, match="unknown span kind"):
        with tr.span("moe_rout", device=CPU):
            pass


def test_use_installs_per_thread_and_restores():
    a, b = StepTracer(), StepTracer()
    seen = []
    assert obs_tracer.current() is NULL_TRACER
    with obs_tracer.use(a):
        t = threading.Thread(
            target=lambda: seen.append(obs_tracer.current()))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        with pytest.raises(RuntimeError):
            with obs_tracer.use(b):
                assert obs_tracer.current() is b
                raise RuntimeError("inside")
        assert obs_tracer.current() is a
    assert obs_tracer.current() is NULL_TRACER
    assert seen == [NULL_TRACER]


# -- the engine ------------------------------------------------------------------

_PARAMS: dict = {}


def _model(arch):
    cfg = get_arch(arch).reduced()
    if arch not in _PARAMS:
        _PARAMS[arch] = Model(cfg).init(seed=3, device="cpu")
    return cfg, _PARAMS[arch]


def _engine(arch, tracing, mode="device", **kw):
    cfg, params = _model(arch)
    tel = Telemetry(tracer=StepTracer(capacity=1 << 14)) if tracing \
        else None
    return Engine(cfg, params, EngineConfig(
        max_batch=4, max_seq_len=64, algorithm="shvs",
        shvs=SHVSConfig(hot_size=128), k_cap=64, sampler_mode=mode,
        samplers=2, **kw), device="cpu", telemetry=tel)


def _requests(cfg):
    reqs = synth_requests(3, cfg.vocab_size, 5, seed=11) + \
        synth_requests(2, cfg.vocab_size, 4, rng_seed=2, greedy=True)
    for i, r in enumerate(reqs):
        r.request_id = 40 + i
    return reqs


def _serve(arch, tracing, mode="device", **kw):
    eng = _engine(arch, tracing, mode, **kw)
    try:
        reqs = _requests(eng.cfg)
        eng.submit(reqs)
        eng.run()
        return [list(r.output) for r in reqs], eng.tracer.events(), \
            list(eng.stats_log)
    finally:
        eng.close()


def _of(events, kind):
    return [e for e in events if e.kind == kind]


def _inside(child, parent):
    return parent.ts <= child.ts and child.end <= parent.end


ARCHS = ["granite-moe-1b-a400m", "rwkv6-3b"]
MODES = ["device", "host"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_committed_tokens_identical_with_tracing_on_and_off(arch, mode):
    off, _, _ = _serve(arch, False, mode)
    on, events, _ = _serve(arch, True, mode)
    assert on == off
    assert all(len(o) for o in on)
    assert _of(events, "dispatch")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_spans_of_a_step(arch, mode):
    _, events, records = _serve(arch, True, mode)
    disp = _of(events, "dispatch")
    # one dispatch per dispatched decode step, each committing one record
    assert sorted(dict(e.args)["step"] for e in disp) == \
        sorted(r.step for r in records)
    assert all(dict(e.args)["rows"] >= 1 for e in disp)
    assert all("device_ms" not in dict(e.args) for e in events)
    samples = _of(events, "device_sample")
    decode = [e for e in samples if dict(e.args)["program"] == "decode"]
    prefill = _of(events, "prefill")
    assert len([e for e in samples if dict(e.args)["program"] ==
                "prefill"]) == len(prefill)
    fetch = _of(events, "fetch_wait")
    if mode == "device":
        by_step = {dict(e.args)["step"]: e for e in disp}
        assert len(decode) == len(disp)
        for e in decode:
            assert _inside(e, by_step[dict(e.args)["step"]])
            assert dict(e.args)["rows"] == 4
        # every device-mode drain waits on its step's tokens
        assert sorted(dict(e.args)["step"] for e in fetch) == \
            sorted(by_step)
    else:
        assert not decode and not fetch
    assert all(set(dict(e.args)) == {"step"} for e in fetch)


@pytest.mark.parametrize("mode", MODES)
def test_moe_route_spans_number_layers_times_programs(mode):
    cfg, _ = _model("granite-moe-1b-a400m")
    _, events, _ = _serve("granite-moe-1b-a400m", True, mode)
    route = _of(events, "moe_route")
    disp, prefill = _of(events, "dispatch"), _of(events, "prefill")
    assert len(route) == cfg.num_layers * (len(disp) + len(prefill))
    k = cfg.moe.top_k
    for d in disp:
        inner = [e for e in route if _inside(e, d)]
        assert len(inner) == cfg.num_layers
        assert all(dict(e.args) == {"pairs": 4 * k} for e in inner)
    for p in prefill:
        assert len([e for e in route if _inside(e, p)]) == cfg.num_layers


def test_chunk_programs_record_their_decision_and_first_tokens_wait():
    _, events, _ = _serve("granite-moe-1b-a400m", True, prompt_chunk=8)
    chunk = [e for e in _of(events, "device_sample")
             if dict(e.args)["program"] == "chunk"]
    assert chunk and all(dict(e.args)["rows"] == 4 for e in chunk)
    # each chunk program's first tokens are one more wait at the drain
    assert len(_of(events, "fetch_wait")) >= \
        len(_of(events, "dispatch")) + 1


def _spy_schedule(eng, seen, fail=False):
    """Record ``current()`` where the step schedules; optionally fail."""
    schedule = eng.scheduler.schedule

    def spy(*a, **kw):
        seen.append(obs_tracer.current())
        if fail:
            raise RuntimeError("schedule failed")
        return schedule(*a, **kw)
    eng.scheduler.schedule = spy


@pytest.mark.parametrize("tracing", [True, False])
def test_current_tracer_is_the_engines_inside_a_step_only(tracing):
    eng = _engine("granite-moe-1b-a400m", tracing)
    want = eng.tracer if tracing else NULL_TRACER
    seen = []
    try:
        eng.submit(_requests(eng.cfg)[:2])
        _spy_schedule(eng, seen)
        assert obs_tracer.current() is NULL_TRACER
        eng.step()
        assert seen == [want] and obs_tracer.current() is NULL_TRACER
        _spy_schedule(eng, seen, fail=True)
        with pytest.raises(RuntimeError, match="schedule failed"):
            eng.step()
        assert seen[-1] is want and obs_tracer.current() is NULL_TRACER
    finally:
        eng.close()
