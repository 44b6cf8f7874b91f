"""The port's pipeline engine against the reference's, on the CPU.

A 4-layer f32 model (d_model 64, V = 512) takes the reference's
``Model.init`` weights through ``models/bridge.py``; requests, sampling
contracts and engine settings are the same on both sides. What must hold:

* ``Model.decode_stage`` composed over p ∈ {1, 2, 4} stages equals the
  port's ``decode_step`` bit for bit (logits and caches), and the
  reference's stages to the tolerance of ``test_torch_model.py``
  (atol = rtol = 1e-4: f32 sums in other orders);
* streams (tokens and finish reasons, exactly) equal to the reference
  ``PipelineEngine`` and to the port's single-stage ``Engine``, for
  contiguous and paged caches, disaggregated and baseline sampling, at
  several (p, M), at any pool width and across placement switches;
* the reserving paged gate, the planner's rejections and its invariants
  (40 hypothesis examples), ``close`` committing what is in flight, and
  ``pipeline_report`` / ``_last_bubble`` equal to the reference's on one
  hand-built cycle log.

The measured bubble comparison needs a card and runs in ``chip_smoke.py``
(phase 7).
"""
from collections import deque

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.config import ModelConfig as JModelConfig
from repro.config import SamplingConfig as JS, SHVSConfig as JSH
from repro.engine import PipelineConfig as JPCfg, PipelineEngine as JPipe
from repro.engine import Request as JRequest
from repro.models.model import Model as JModel
from repro.models.transformer import slice_stage_cache as jslice_cache
from repro.models.transformer import slice_stage_params as jslice_params
from repro.obs import CycleRecord as JCycle
from repro_torch.config import ModelConfig as TModelConfig
from repro_torch.config import SamplingConfig as TS, SHVSConfig as TSH
from repro_torch.config import get_arch
from repro_torch.core.autotune import ControllerAction
from repro_torch.engine.engine import Engine as TEngine, EngineConfig as TECfg
from repro_torch.engine.pipeline import (MicrobatchPlanner, PipelineConfig,
                                         PipelineEngine)
from repro_torch.engine.request import Request as TRequest
from repro_torch.models.bridge import from_jax_params
from repro_torch.models.model import Model as TModel
from repro_torch.models.transformer import (slice_stage_cache,
                                            slice_stage_params, stage_bounds)
from repro_torch.obs import CycleRecord

MODEL = dict(name="pipe-tiny", family="dense", num_layers=4, d_model=64,
             num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=512,
             dtype="float32")
ENGINE = dict(max_seq_len=64, algorithm="shvs", k_cap=64, prompt_bucket=8,
              block_size=8)


@pytest.fixture(scope="module")
def model4():
    jcfg = JModelConfig(**MODEL)
    jp = JModel(jcfg).init(jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp))
    return jcfg, jp, TModelConfig(**MODEL), tp


def _reqs(Request, Sampling, n=9, seed=0, max_new=6, **skw):
    """Heterogeneous lengths and stop conditions: slot churn across
    microbatch groups, staggered retirement."""
    rng = np.random.default_rng(seed)
    return [Request(
        request_id=i,
        prompt=rng.integers(1, MODEL["vocab_size"],
                            int(rng.integers(3, 12))).tolist(),
        max_new_tokens=int(rng.integers(2, max_new + 1)),
        sampling=Sampling(temperature=0.9, top_k=30, top_p=0.95,
                          repetition_penalty=1.1, **skw))
        for i in range(n)]


def _streams(reqs):
    return {r.request_id: (list(r.output), r.finish_reason) for r in reqs}


def _single(model, reqs, **kw):
    _, _, tcfg, tp = model
    eng = TEngine(tcfg, tp, TECfg(shvs=TSH(hot_size=64),
                                  **dict(ENGINE, max_batch=4, **kw)),
                  device="cpu")
    eng.submit(reqs)
    done = eng.run(max_steps=800)
    eng.close()
    assert len(done) == len(reqs)
    return _streams(reqs)


def _pipeline_engine(model, *, stages, microbatches, rows=2, **kw):
    _, _, tcfg, tp = model
    ekw = dict(ENGINE, max_batch=rows * microbatches, stages=stages,
               microbatches=microbatches, samplers=2)
    ekw.update(kw)
    return PipelineEngine(tcfg, tp, PipelineConfig(shvs=TSH(hot_size=64),
                                                   **ekw), device="cpu")


def _pipeline(model, reqs, **kw):
    eng = _pipeline_engine(model, **kw)
    eng.submit(reqs)
    done = eng.run(max_steps=20_000)
    eng.close()
    assert len(done) == len(reqs)
    return _streams(reqs), eng


@pytest.fixture(scope="module")
def reference(model4):
    """The reference PipelineEngine's streams at p = 2, M = 4 (host pool,
    contiguous); its own suite holds them equal across (p, M), caches and
    modes."""
    jcfg, jp, _, _ = model4
    eng = JPipe(jcfg, jp, JPCfg(max_batch=8, stages=2, microbatches=4,
                                samplers=2, shvs=JSH(hot_size=64), **ENGINE))
    reqs = _reqs(JRequest, JS)
    eng.submit(reqs)
    done = eng.run(max_steps=20_000)
    eng.close()
    assert len(done) == len(reqs)
    return _streams(reqs)


# ---------------------------------------------------------------------------
# Stage split
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stages", [1, 2, 4])
def test_decode_stage_composes_to_decode_step(model4, stages):
    jcfg, jp, tcfg, tp = model4
    jm, tm = JModel(jcfg), TModel(tcfg)
    rs = np.random.default_rng(stages)
    B, S, Smax = 3, 9, 24
    toks = rs.integers(1, 512, (B, S)).astype(np.int32)
    lens = np.array([9, 4, 6], np.int32)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                        tm.init_cache(B, Smax, device="cpu"),
                        true_lens=torch.from_numpy(lens))
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                        jm.init_cache(B, Smax), true_lens=jnp.asarray(lens))
    staged = {k: v.clone() for k, v in tc.items()}
    bounds = stage_bounds(tcfg.num_layers, stages)
    for _ in range(3):
        nxt = tl.argmax(-1).to(torch.int32)
        tl, tc = tm.decode_step(tp, nxt, tc)
        x = nxt
        for s, (lo, hi) in enumerate(bounds):
            last = s == stages - 1
            sp = {"stack": slice_stage_params(tp["stack"], lo, hi, last=last),
                  "emb": tp["emb"]}
            x, out = tm.decode_stage(sp, x, slice_stage_cache(staged, lo, hi),
                                     first=s == 0, last=last)
        staged["len"], staged["pos"] = out["len"], out["pos"]
        assert torch.equal(x, tl)
        jx = jnp.asarray(nxt.numpy())
        for s, (lo, hi) in enumerate(bounds):
            last = s == stages - 1
            sp = {"stack": jslice_params(jp["stack"], lo, hi, last=last),
                  "emb": jp["emb"]}
            jx, jout = jm.decode_stage(sp, jx, jslice_cache(jc, lo, hi),
                                       first=s == 0, last=last)
            for k in ("k", "v"):
                jc[k] = jc[k].at[lo:hi].set(jout[k])
        jc["len"], jc["pos"] = jout["len"], jout["pos"]
        np.testing.assert_allclose(np.asarray(jx), x.numpy(), rtol=1e-4,
                                   atol=1e-4)
    for k in ("k", "v"):
        assert torch.equal(staged[k], tc[k])
    assert torch.equal(staged["len"], tc["len"])


# ---------------------------------------------------------------------------
# Streams
# ---------------------------------------------------------------------------


def test_single_stage_engine_matches_reference_pipeline(model4, reference):
    assert _single(model4, _reqs(TRequest, TS), overlap=False) == reference
    assert _single(model4, _reqs(TRequest, TS), cache="paged") == reference


@pytest.mark.parametrize("cache,stages,microbatches,mode", [
    ("contiguous", 2, 2, "disaggregated"),
    ("contiguous", 2, 4, "disaggregated"),
    ("contiguous", 4, 4, "disaggregated"),
    ("paged", 2, 4, "disaggregated"),
    ("paged", 4, 8, "disaggregated"),
    ("contiguous", 2, 4, "baseline"),
    ("paged", 2, 4, "baseline")])
def test_pipeline_streams_match_reference(model4, reference, cache, stages,
                                          microbatches, mode):
    got, eng = _pipeline(model4, _reqs(TRequest, TS), stages=stages,
                         microbatches=microbatches, sampler_mode=mode,
                         cache=cache)
    assert got == reference
    assert eng.client.mode == ("device" if mode == "baseline" else "host")
    assert eng.pipeline_report()["cycles"] > 0
    if cache == "paged":
        # reserving admission: no preemption, no leaked blocks
        assert eng.scheduler.preemptions == 0
        assert eng.alloc.num_free == eng.pcfg.num_blocks


@pytest.mark.parametrize("samplers", [1, 8])
def test_sampler_pool_width_invariance(model4, reference, samplers):
    got, _ = _pipeline(model4, _reqs(TRequest, TS), stages=2,
                       microbatches=4, rows=4, samplers=samplers)
    assert got == reference


def test_placement_switches_keep_streams(model4, reference):
    """Host → device → host mid-run (the adaptive controller's action):
    every in-flight microbatch commits under the placement it was
    dispatched with, and the histograms move with the switch."""
    eng = _pipeline_engine(model4, stages=2, microbatches=4,
                           sampler_mode="adaptive")
    reqs = _reqs(TRequest, TS)
    eng.submit(reqs)
    for mode in ("device", "host"):
        for _ in range(7):
            eng.step()
        eng._apply_action(ControllerAction(sampler_mode=mode),
                          eng.stats_log[-1], 0)
        home = "cpu" if mode == "host" else eng.device.type
        assert all(ps.output_counts.device.type == home for ps in eng.pstate)
    eng.run(max_steps=20_000)
    eng.close()
    assert _streams(reqs) == reference


@pytest.mark.parametrize("kind", ["seed", "greedy"])
def test_per_request_contract_through_pipeline(model4, kind):
    skw = {"seed": dict(seed=100), "greedy": dict(greedy=True)}[kind]
    mk = lambda: [TRequest(r.request_id, list(r.prompt), r.max_new_tokens,
                           TS(temperature=0.9, top_k=30, **skw))
                  for r in _reqs(TRequest, TS, n=6, seed=3)]
    got, _ = _pipeline(model4, mk(), stages=2, microbatches=4)
    assert got == _single(model4, mk())


def test_generate_stream_matches_run(model4, reference):
    eng = _pipeline_engine(model4, stages=2, microbatches=2)
    reqs = _reqs(TRequest, TS)
    streams, finishes = {}, {}
    for ev in eng.generate(reqs, max_steps=20_000):
        if ev.token is not None:
            streams.setdefault(ev.request_id, []).append(ev.token)
        if ev.finish_reason is not None:
            finishes[ev.request_id] = ev.finish_reason
    eng.close()
    assert {k: (v, finishes[k]) for k, v in streams.items()} == reference
    assert set(finishes) == {r.request_id for r in reqs}


# ---------------------------------------------------------------------------
# The reserving paged gate
# ---------------------------------------------------------------------------


def test_paged_reserving_admission_throttles(model4, reference):
    """A pool far smaller than the total demand admits in waves; streams
    are unchanged, with no preemption and no leaked block."""
    got, eng = _pipeline(model4, _reqs(TRequest, TS), stages=2,
                         microbatches=2, cache="paged", num_blocks=24)
    assert got == reference
    assert eng.scheduler.preemptions == 0
    assert eng.alloc.num_free == eng.pcfg.num_blocks


def test_reserving_gate_admits_exact_fit_in_one_round(model4):
    """Two requests whose worst cases exactly fill the pool are admitted
    in the same round (the gate must not count a round's earlier admits
    twice)."""
    eng = _pipeline_engine(model4, stages=1, microbatches=1, cache="paged",
                           num_blocks=4)
    # prompt 8 + max_new 8 = 16 tokens = exactly 2 blocks of 8 each
    eng.submit([TRequest(i, list(range(1, 9)), 8) for i in range(2)])
    eng.step()
    assert eng.scheduler.num_active() == 2
    assert len(eng.run(max_steps=5000)) == 2
    eng.close()
    assert eng.alloc.num_free == eng.pcfg.num_blocks


def test_oversized_request_rejected_at_submit(model4):
    eng = _pipeline_engine(model4, stages=2, microbatches=2, cache="paged",
                           num_blocks=4)
    with pytest.raises(ValueError, match="KV blocks"):
        eng.submit([TRequest(0, list(range(1, 40)), 30)])
    eng.close()


def test_moe_family_names_its_roadmap_item(model4):
    """The MoE family is served (its streams are held to the reference's
    in ``test_torch_moe.py``); a recurrent family and the VLM are refused
    with the reference's message, and the audio family (whisper) names
    ROADMAP Fault 7."""
    cfg = get_arch("granite-moe-1b-a400m").reduced()
    eng = PipelineEngine(cfg, TModel(cfg).init(seed=0, device="cpu"),
                         PipelineConfig(**ENGINE), device="cpu")
    eng.close()
    with pytest.raises(AssertionError, match="dense/moe decoders only"):
        PipelineEngine(get_arch("rwkv6-3b").reduced(), None,
                       PipelineConfig(**ENGINE), device="cpu")
    with pytest.raises(AssertionError, match="dense/moe decoders only"):
        PipelineEngine(get_arch("internvl2-2b").reduced(), None,
                       PipelineConfig(**ENGINE), device="cpu")
    with pytest.raises(NotImplementedError, match="Fault 7"):
        PipelineEngine(get_arch("whisper-base").reduced(), None,
                       PipelineConfig(**ENGINE), device="cpu")


# ---------------------------------------------------------------------------
# The planner and the lifecycle
# ---------------------------------------------------------------------------


def _dispatch_one(planner, slot=0):
    req = TRequest(0, [1, 2], 4)
    req.slot = slot
    planner.dispatch(0, np.array([True]), [req], np.zeros(1, np.uint32),
                     np.zeros(1, np.int32))
    return req


def test_planner_rejects_early_commit():
    planner = MicrobatchPlanner(2, 4, 1)
    _dispatch_one(planner)
    planner.tick()
    planner.tick()
    with pytest.raises(KeyError):
        planner.commit(1)          # never dispatched
    planner.tick()
    with pytest.raises(AssertionError):
        planner.commit(0)          # no last-stage exit yet


def test_planner_rejects_double_dispatch():
    planner = MicrobatchPlanner(1, 1, 1)
    req = _dispatch_one(planner)
    with pytest.raises(AssertionError):
        planner.dispatch(0, np.array([True]), [req], np.zeros(1, np.uint32),
                         np.zeros(1, np.int32))


def test_close_commits_in_flight_microbatches(model4):
    eng = _pipeline_engine(model4, stages=2, microbatches=2)
    reqs = _reqs(TRequest, TS, n=4)
    eng.submit(reqs)
    for _ in range(4):        # leaves microbatches mid-pipeline
        eng.step()
    assert eng.in_flight > 0
    eng.close()
    assert eng.in_flight == 0, "close() dropped in-flight tokens"


@given(st.data())
@settings(max_examples=40, deadline=None)
def test_microbatch_planner_invariants(data):
    """Random dispatch/idle schedules through the cycle clock: no slot is
    covered by two in-flight microbatches, no token commits before its
    re-entry cycle, and each slot's tokens commit in dispatch order."""
    p = data.draw(st.integers(1, 4))
    M = p * data.draw(st.integers(1, 3))
    R = data.draw(st.integers(1, 3))
    planner = MicrobatchPlanner(p, M, R)
    requests = {}
    for slot in range(M * R):
        r = TRequest(request_id=slot, prompt=[1], max_new_tokens=1 << 30)
        r.slot = slot
        requests[slot] = r
    fed = [0] * (M * R)
    committed = [[] for _ in range(M * R)]
    stage_pos, sampled = {}, {}

    def mark_exit(i, active_slots):
        planner.mark_exit(i)
        sampled[i] = {}
        for slot in active_slots:
            sampled[i][slot] = fed[slot]
            fed[slot] += 1

    n_cycles = data.draw(st.integers(1, 50))
    for cycle in range(n_cycles + 2 * (M + p)):
        draining = cycle >= n_cycles
        c = planner.cycle
        for s in range(p - 1, -1, -1):
            i = planner.stage_for(c, s)
            if s > 0:
                if stage_pos.get(i) == s:
                    if s == p - 1:
                        rec = planner.inflight[i]
                        mark_exit(i, [r.slot for a, r in
                                      zip(rec.active, rec.slot_request)
                                      if a])
                        del stage_pos[i]
                    else:
                        stage_pos[i] = s + 1
                continue
            if i in sampled:
                rec = planner.commit(i)
                assert planner.cycle >= rec.exit_cycle + 1
                for slot, seq in sampled.pop(i).items():
                    committed[slot].append(seq)
            if draining or i in stage_pos:
                continue
            group = list(planner.group_slots(i))
            active = np.array([data.draw(st.booleans()) for _ in group])
            if not active.any():
                continue
            planner.dispatch(i, active, [requests[g] for g in group],
                             np.zeros(len(group), np.uint32),
                             np.zeros(len(group), np.int32))
            if p == 1:
                mark_exit(i, [g for g, a in zip(group, active) if a])
            else:
                stage_pos[i] = 1
        planner.tick()
    assert not planner.inflight and not sampled and not stage_pos
    for slot in range(M * R):
        assert committed[slot] == list(range(fed[slot]))


def test_pipeline_report_matches_reference():
    """Eq. 4's quantities from one hand-built cycle log: fill cycles (a
    stage idle), full cycles with a pool stall and with a synchronous
    draw, and a drain cycle."""
    rows = [dict(cycle=0, busy=[0.010, None, None]),
            dict(cycle=1, busy=[0.011, 0.013, None], stall=0.002),
            dict(cycle=2, busy=[0.009, 0.012, 0.020], stall=0.004,
                 sampler=0.015, transfer=0.001),
            dict(cycle=3, busy=[0.010, 0.014, 0.018], sample=0.006),
            dict(cycle=4, busy=[0.012, 0.011, 0.016], stall=0.0,
                 sampler=0.010, transfer=0.0005),
            dict(cycle=5, busy=[None, 0.012, 0.017])]
    reports = []
    for Eng, Rec in ((PipelineEngine, CycleRecord), (JPipe, JCycle)):
        eng = Eng.__new__(Eng)
        eng.p, eng.M = 3, 3
        eng.cycle_log = deque(Rec(**r) for r in rows)
        reports.append((eng.pipeline_report(), eng._last_bubble()))
    (port, pb), (ref, rb) = reports
    assert port.keys() == ref.keys() and port["cycles"] == ref["cycles"] == 3
    for k in port:
        np.testing.assert_allclose(port[k], ref[k], rtol=1e-12)
    assert pb == rb
