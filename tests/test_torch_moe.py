"""The port's MoE family against the reference, on the CPU.

Reduced f32 ``granite-moe-1b-a400m`` (4 experts, top-2) and
``llama4-maverick-400b-a17b`` (4 experts, top-1, the shared expert) take
the reference's ``Model.init`` weights through ``models/bridge.py``. The
reduced configs set ``capacity_factor = E``, so no pair is ever dropped;
the cases named "drop" lower it to 0.5 so that prefill drops pairs
(decode at 4 slots still fits: C = max(8, ...) = T·k).

Tolerance: logits and every cache leaf allclose at atol = rtol = 2e-4
(the reference's own prefill/decode consistency tolerance: f32 sums in
other orders); greedy argmax equal. Engine streams (tokens and finish
reasons) are equal exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import SamplingConfig as JS, SHVSConfig as JSH
from repro.config import get_arch as jget
from repro.engine import PipelineConfig as JPCfg, PipelineEngine as JPipe
from repro.engine.engine import Engine as JEngine, EngineConfig as JECfg
from repro.engine.request import Request as JRequest
from repro.models import moe as jmoe
from repro.models.model import Model as JModel
from repro_torch.config import SamplingConfig as TS, SHVSConfig as TSH
from repro_torch.config import get_arch as tget
from repro_torch.engine.engine import Engine as TEngine, EngineConfig as TECfg
from repro_torch.engine.pipeline import PipelineConfig, PipelineEngine
from repro_torch.engine.request import Request as TRequest
from repro_torch.models import moe as tmoe
from repro_torch.models.bridge import from_jax_params
from repro_torch.models.model import Model as TModel

GRANITE, LLAMA4 = "granite-moe-1b-a400m", "llama4-maverick-400b-a17b"
TOL = dict(rtol=2e-4, atol=2e-4)
ENGINE = dict(max_batch=4, max_seq_len=64, k_cap=64)


def _cfgs(arch, capacity_factor=None):
    """(reference cfg, port cfg), reduced, with the capacity factor
    lowered where one is given."""
    out = []
    for get in (jget, tget):
        cfg = get(arch).reduced()
        if capacity_factor is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=capacity_factor))
        out.append(cfg)
    return out


def _weights(cfg, seed=3):
    p = JModel(cfg).init(jax.random.PRNGKey(seed))
    return p, from_jax_params(jax.tree_util.tree_map(np.asarray, p))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(j, t):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               **TOL)


# ---------------------------------------------------------------------------
# The MoE layer
# ---------------------------------------------------------------------------


def test_apply_moe_drops_match_reference():
    """``capacity_factor = 0.5`` at B = 2, S = 16 (T·k = 64 pairs over 4
    experts, C = 8): pairs are dropped, and the output equals the
    reference's, for each layer's weights."""
    jcfg, tcfg = _cfgs(GRANITE, 0.5)
    p, tp = _weights(jcfg)
    x = np.random.default_rng(1).normal(
        size=(2, 16, jcfg.d_model)).astype(np.float32)
    m = jcfg.moe
    cap = jmoe._capacity(32, m.top_k, m.num_experts, m.capacity_factor)
    assert cap == tmoe._capacity(32, m.top_k, m.num_experts,
                                 m.capacity_factor) == 8
    for layer in range(jcfg.num_layers):
        jp = jax.tree_util.tree_map(lambda a: a[layer], p["stack"]["moe"])
        tpl = {k: v[layer] for k, v in tp["stack"]["moe"].items()}
        want, want_aux = jmoe.apply_moe(jp, jnp.asarray(x), jcfg)
        got, aux = tmoe.apply_moe(tpl, _t(x), tcfg)
        _close(want, got)
        assert aux == float(want_aux) == 0.0   # weighed by 0 outside training
        ids, _, _ = tmoe._route(tpl["router"], _t(x).reshape(32, -1),
                                m.num_experts, m.top_k)
        load = np.bincount(ids.numpy().ravel(), minlength=m.num_experts)
        assert np.maximum(load - cap, 0).sum() > 0, "no pair was dropped"


def test_route_ties_rank_lower_expert_first():
    """Equal router probabilities (a zero router) pick experts 0, 1, ... in
    order, as ``jax.lax.top_k`` does; gates and probs equal the
    reference's."""
    x = np.random.default_rng(2).normal(size=(6, 32)).astype(np.float32)
    w = np.zeros((32, 4), np.float32)
    jids, jg, jp = jmoe._route(jnp.asarray(w), jnp.asarray(x), 4, 2)
    ids, g, p = tmoe._route(_t(w), _t(x), 4, 2)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(ids.numpy(), np.tile([0, 1], (6, 1)))
    _close(jg, g)
    _close(jp, p)
    # a partial tie: experts 1 and 2 tie above 0 and 3
    w[:5, 1] = w[:5, 2] = 0.3
    x = np.abs(x)
    jids, _, _ = jmoe._route(jnp.asarray(w), jnp.asarray(x), 4, 2)
    ids, _, _ = tmoe._route(_t(w), _t(x), 4, 2)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(ids.numpy()[:, 0], 1)


def test_aux_loss_matches_reference():
    rs = np.random.default_rng(5)
    probs = rs.dirichlet(np.ones(4), size=12).astype(np.float32)
    ids = rs.integers(0, 4, (12, 2)).astype(np.int32)
    want = jmoe._aux_loss(jnp.asarray(probs), jnp.asarray(ids), 4)
    got = tmoe._aux_loss(_t(probs), _t(ids).long(), 4)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

MODEL_CASES = [(GRANITE, None), (GRANITE, 0.5), (LLAMA4, None)]


@pytest.mark.parametrize("arch,factor", MODEL_CASES)
def test_prefill_and_decode_match_reference(arch, factor):
    """Right-padded prefill with ``true_lens``, then 3 decode steps."""
    jcfg, tcfg = _cfgs(arch, factor)
    p, tp = _weights(jcfg)
    jm, tm = JModel(jcfg), TModel(tcfg)
    rs = np.random.default_rng(0)
    B, S, Smax = 3, 12, 24
    toks = rs.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    lens = np.array([12, 7, 9], np.int32)
    jc, tc = jm.init_cache(B, Smax), tm.init_cache(B, Smax, device="cpu")
    jl, jc = jm.prefill(p, {"tokens": jnp.asarray(toks)}, jc,
                        true_lens=jnp.asarray(lens))
    tl, tc = tm.prefill(tp, {"tokens": _t(toks)}, tc, true_lens=_t(lens))
    _close(jl, tl)
    for _ in range(3):
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)
        assert np.array_equal(nxt, tl.numpy().argmax(-1))
        jl, jc = jm.decode_step(p, jnp.asarray(nxt), jc)
        tl, tc = tm.decode_step(tp, _t(nxt), tc)
        _close(jl, tl)
    assert sorted(jc) == sorted(tc)
    for k in jc:
        _close(jc[k], tc[k])


@pytest.mark.parametrize("factor", [None, 0.5])
def test_prefill_chunk_matches_reference(factor):
    """Two chunks on three rows, one row outside the second chunk's mask
    (its K/V and len untouched), then a decode step."""
    jcfg, tcfg = _cfgs(GRANITE, factor)
    p, tp = _weights(jcfg)
    jm, tm = JModel(jcfg), TModel(tcfg)
    B, S, C = 3, 32, 8
    rs = np.random.default_rng(4)
    jc, tc = jm.init_cache(B, S), tm.init_cache(B, S, device="cpu")
    for counts, mask in ((np.array([8, 8, 5], np.int32), [1, 1, 1]),
                         (np.array([3, 8, 0], np.int32), [1, 1, 0])):
        mask = np.array(mask, bool)
        toks = rs.integers(1, jcfg.vocab_size, (B, C)).astype(np.int32)
        jl, jc = jm.prefill_chunk(p, jnp.asarray(toks), jc,
                                  jnp.asarray(counts), jnp.asarray(mask))
        tl, tc = tm.prefill_chunk(tp, _t(toks), tc, _t(counts), _t(mask))
        _close(jl, tl)
        np.testing.assert_array_equal(tc["len"].numpy(),
                                      np.asarray(jc["len"]))
    nxt = rs.integers(1, jcfg.vocab_size, B).astype(np.int32)
    jl, jc = jm.decode_step(p, jnp.asarray(nxt), jc)
    tl, tc = tm.decode_step(tp, _t(nxt), tc)
    _close(jl, tl)
    for k in ("k", "v"):
        _close(jc[k], tc[k])


@pytest.mark.parametrize("arch", [GRANITE, LLAMA4])
def test_prefill_decode_consistency(arch):
    """The port alone, as the reference's ``tests/test_models.py``:
    prefill(T-3) + 3 teacher-forced decode steps equal prefill(T)."""
    tm = TModel(tget(arch).reduced())
    params = tm.init(seed=0, device="cpu")
    B, T = 2, 10
    toks = torch.randint(0, tm.cfg.vocab_size, (B, T),
                         generator=torch.Generator().manual_seed(3),
                         dtype=torch.int32)
    full, _ = tm.prefill(params, {"tokens": toks},
                         tm.init_cache(B, 32, device="cpu"))
    logits, cache = tm.prefill(params, {"tokens": toks[:, :T - 3]},
                               tm.init_cache(B, 32, device="cpu"))
    for t in range(T - 3, T):
        logits, cache = tm.decode_step(params, toks[:, t], cache)
    torch.testing.assert_close(logits, full, **TOL)


@pytest.mark.parametrize("arch", [GRANITE, LLAMA4])
def test_port_init_has_the_reference_layout(arch):
    cfg = jget(arch).reduced()
    ref = jax.eval_shape(lambda: JModel(cfg).init(jax.random.PRNGKey(0)))
    got = TModel(tget(arch).reduced()).init(seed=0, device="cpu")

    def layout(tree):
        return {k: layout(v) if isinstance(v, dict) else
                (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in tree.items()}
    assert layout(got) == layout(ref)


# ---------------------------------------------------------------------------
# The engines
# ---------------------------------------------------------------------------


def _requests(Request, Sampling, vocab, n=6):
    """More requests than slots (slot reuse), seeded, engine-keyed and
    greedy rows."""
    rs = np.random.default_rng(3)
    return [Request(
        request_id=i,
        prompt=rs.integers(1, vocab, int(rs.integers(4, 20))).tolist(),
        max_new_tokens=4 + i,
        sampling=Sampling(temperature=0.8, top_k=40 if i % 2 else 0,
                          top_p=0.95, repetition_penalty=1.1,
                          seed=100 + i if i % 2 == 0 else None,
                          greedy=i == 3))
        for i in range(n)]


def _run(Engine, ECfg, Request, Sampling, SHVS, cfg, params, algorithm,
         **kw):
    extra = dict(device="cpu") if Engine is TEngine else {}
    eng = Engine(cfg, params, ECfg(algorithm=algorithm,
                                   shvs=SHVS(hot_size=128),
                                   **dict(ENGINE, **kw)), **extra)
    reqs = _requests(Request, Sampling, cfg.vocab_size)
    list(eng.generate(reqs))
    eng.close()
    return [(r.output, r.finish_reason) for r in reqs], eng


@pytest.fixture(scope="module")
def granite():
    jcfg, tcfg = _cfgs(GRANITE)
    p, tp = _weights(jcfg, seed=0)
    return jcfg, tcfg, p, tp


@pytest.fixture(scope="module")
def reference_streams(granite):
    jcfg, _, p, _ = granite
    run = lambda algorithm: _run(JEngine, JECfg, JRequest, JS, JSH, jcfg, p,
                                 algorithm)[0]
    return {a: run(a) for a in ("shvs", "fused")}


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("algorithm", ["shvs", "fused"])
def test_engine_streams_match_reference(granite, reference_streams,
                                        algorithm, overlap):
    _, tcfg, _, tp = granite
    got, eng = _run(TEngine, TECfg, TRequest, TS, TSH, tcfg, tp, algorithm,
                    overlap=overlap)
    assert got == reference_streams[algorithm]
    assert eng.in_flight == 0


@pytest.mark.parametrize("overlap", [True, False])
def test_paged_chunked_gumbel_with_drops_matches_reference(overlap,
                                                           monkeypatch):
    """The paged cache with chunked prefill (8) under ``gumbel``, at
    ``capacity_factor = 0.5``: the prefill calls drop pairs (counted
    through the port's slot assignment); the streams equal the
    reference's on the same settings."""
    jcfg, tcfg = _cfgs(GRANITE, 0.5)
    p, tp = _weights(jcfg, seed=0)
    kw = dict(cache="paged", block_size=8, prompt_chunk=8, overlap=overlap)
    want, _ = _run(JEngine, JECfg, JRequest, JS, JSH, jcfg, p, "gumbel",
                   **kw)
    dropped = []
    slots = tmoe._slots

    def counting(ids_flat, num_experts, capacity):
        out = slots(ids_flat, num_experts, capacity)
        dropped.append(int((~out[2]).sum()))
        return out

    monkeypatch.setattr(tmoe, "_slots", counting)
    got, eng = _run(TEngine, TECfg, TRequest, TS, TSH, tcfg, tp, "gumbel",
                    **kw)
    assert sum(dropped) > 0, "no pair was dropped"
    assert eng.scheduler.prompt_chunk == 8
    assert got == want
    assert eng.alloc.num_free == eng.pcfg.num_blocks


def test_pipeline_streams_match_reference(granite):
    """``PipelineEngine`` at (p, M) = (2, 2), the decision in the host
    pool: the reference pipeline's streams."""
    jcfg, tcfg, p, tp = granite
    kw = dict(ENGINE, stages=2, microbatches=2, samplers=2)
    streams = []
    for Pipe, PCfg, Request, Sampling, SHVS, cfg, params, extra in (
            (JPipe, JPCfg, JRequest, JS, JSH, jcfg, p, {}),
            (PipelineEngine, PipelineConfig, TRequest, TS, TSH, tcfg, tp,
             dict(device="cpu"))):
        eng = Pipe(cfg, params, PCfg(algorithm="shvs",
                                     shvs=SHVS(hot_size=128), **kw), **extra)
        reqs = _requests(Request, Sampling, cfg.vocab_size)
        eng.submit(reqs)
        assert len(eng.run(max_steps=5000)) == len(reqs)
        eng.close()
        streams.append([(r.output, r.finish_reason) for r in reqs])
    assert streams[0] == streams[1]
