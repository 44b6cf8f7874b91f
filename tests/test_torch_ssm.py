"""The port's recurrent families against the reference, on the CPU.

Reduced f32 ``rwkv6-3b`` (RWKV-6) and ``zamba2-1.2b`` (Mamba2 with a
shared attention block every 2 layers) take the reference's
``Model.init`` weights through ``models/bridge.py``.

Tolerance: logits and every cache leaf (the f32 recurrent states, token
shifts, conv carry and shared-attention K/V) allclose at atol = rtol =
2e-4 (the reference's own prefill/decode consistency tolerance: f32 sums
in other orders); greedy argmax equal. Engine streams (tokens and finish
reasons) are equal exactly.

The reference's recurrent state absorbs a right-padded prompt's pad
tokens (ROADMAP Fault 6), so a stream depends on ``prompt_bucket``; the
port reproduces that, and the test of it pins both buckets.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import SamplingConfig as JS, SHVSConfig as JSH
from repro.config import get_arch as jget
from repro.engine.engine import Engine as JEngine, EngineConfig as JECfg
from repro.engine.request import Request as JRequest
from repro.models.model import Model as JModel
from repro_torch.config import SamplingConfig as TS, SHVSConfig as TSH
from repro_torch.config import get_arch as tget
from repro_torch.engine.engine import Engine as TEngine, EngineConfig as TECfg
from repro_torch.engine.request import Request as TRequest
from repro_torch.models.bridge import from_jax_params
from repro_torch.models.model import Model as TModel

RWKV, ZAMBA = "rwkv6-3b", "zamba2-1.2b"
ARCHS = [RWKV, ZAMBA]
TOL = dict(rtol=2e-4, atol=2e-4)
ENGINE = dict(max_batch=4, max_seq_len=64, k_cap=64)


def _weights(arch, seed=3):
    p = JModel(jget(arch).reduced()).init(jax.random.PRNGKey(seed))
    return p, from_jax_params(jax.tree_util.tree_map(np.asarray, p))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(j, t):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               **TOL)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """Right-padded prefill with ``true_lens`` (the pad tokens run through
    the recurrence, as in the reference), then 3 decode steps: logits and
    every cache leaf."""
    cfg = jget(arch).reduced()
    p, tp = _weights(arch)
    jm, tm = JModel(cfg), TModel(tget(arch).reduced())
    rs = np.random.default_rng(0)
    B, S, Smax = 3, 12, 24
    toks = rs.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
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
        assert tc[k].dtype == getattr(torch, str(jc[k].dtype)), k
        _close(jc[k], tc[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency(arch):
    """The port alone, as the reference's ``tests/test_models.py``:
    prefill(T-3) + 3 teacher-forced decode steps equal prefill(T), the
    recurrent state carried across."""
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


@pytest.mark.parametrize("arch", ARCHS)
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
# The engine
# ---------------------------------------------------------------------------


def _requests(Request, Sampling, vocab, n=6):
    """More requests than slots: an admitted row takes a slot whose
    previous occupant left its recurrent state there."""
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
         reqs=None, **kw):
    extra = dict(device="cpu") if Engine is TEngine else {}
    eng = Engine(cfg, params, ECfg(algorithm=algorithm,
                                   shvs=SHVS(hot_size=128),
                                   **dict(ENGINE, **kw)), **extra)
    reqs = reqs or _requests(Request, Sampling, cfg.vocab_size)
    list(eng.generate(reqs))
    eng.close()
    return [(r.output, r.finish_reason) for r in reqs], eng


def _port(arch, tp, algorithm, **kw):
    return _run(TEngine, TECfg, TRequest, TS, TSH, tget(arch).reduced(), tp,
                algorithm, **kw)


@pytest.fixture(scope="module")
def family():
    """Per arch: (reference params, port params, the reference engine's
    streams for shvs and fused)."""
    out = {}
    for arch in ARCHS:
        p, tp = _weights(arch, seed=0)
        cfg = jget(arch).reduced()
        out[arch] = (p, tp, {a: _run(JEngine, JECfg, JRequest, JS, JSH, cfg,
                                     p, a)[0] for a in ("shvs", "fused")})
    return out


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("algorithm", ["shvs", "fused"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_streams_match_reference(family, arch, algorithm, overlap):
    _, tp, want = family[arch]
    got, eng = _port(arch, tp, algorithm, overlap=overlap)
    assert got == want[algorithm]
    assert eng.in_flight == 0


def test_host_placement_matches_reference(family):
    """``rwkv6-3b`` with the decision in the host sampler pool (2 workers):
    the reference engine's device streams (host ≡ device holds in both
    packages)."""
    _, tp, want = family[RWKV]
    got, eng = _port(RWKV, tp, "shvs", sampler_mode="host", samplers=2)
    assert got == want["shvs"]
    assert sum(1 for s in eng.stats_log if "stall_ms" in s) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_chunking_is_ignored_and_paging_refused(family, arch):
    """The reference's gates: ``prompt_chunk`` is ignored for a recurrent
    family (the prompt prefills whole: the streams are the unchunked
    ones), and ``cache="paged"`` raises in both packages."""
    _, tp, want = family[arch]
    got, eng = _port(arch, tp, "shvs", prompt_chunk=8)
    assert eng.scheduler.prompt_chunk == 0
    assert got == want["shvs"]
    p, _, _ = family[arch]
    msg = "full-causal dense/moe decoders only"
    with pytest.raises(AssertionError, match=msg):
        JEngine(jget(arch).reduced(), p,
                JECfg(cache="paged", block_size=8, **ENGINE))
    with pytest.raises(AssertionError, match=msg):
        TEngine(tget(arch).reduced(), tp,
                TECfg(cache="paged", block_size=8, **ENGINE), device="cpu")


def test_prompt_bucket_changes_recurrent_streams_as_in_reference():
    """ROADMAP Fault 6, the smallest input: one greedy request with a
    5-token prompt on reduced ``rwkv6-3b`` (the reference's init at
    ``PRNGKey(0)``), 6 new tokens, at prompt buckets 8 and 32. The pad
    tokens run through the recurrence, so the reference's streams differ
    between the buckets; the port's equal the reference's at each."""
    p, tp = _weights(RWKV, seed=0)
    prompt = np.random.default_rng(0).integers(1, 512, 5).tolist()
    streams = {}
    for pkg, (Engine, ECfg, Request, Sampling, SHVS, cfg, params) in (
            ("ref", (JEngine, JECfg, JRequest, JS, JSH,
                     jget(RWKV).reduced(), p)),
            ("port", (TEngine, TECfg, TRequest, TS, TSH,
                      tget(RWKV).reduced(), tp))):
        for bucket in (8, 32):
            reqs = [Request(request_id=0, prompt=list(prompt),
                            max_new_tokens=6,
                            sampling=Sampling(greedy=True))]
            streams[pkg, bucket] = _run(
                Engine, ECfg, Request, Sampling, SHVS, cfg, params,
                "shvs", reqs=reqs, prompt_bucket=bucket)[0]
    assert streams["ref", 8] != streams["ref", 32]
    assert streams["port", 8] == streams["ref", 8]
    assert streams["port", 32] == streams["ref", 32]
    assert streams["ref", 8][0][0][0] == streams["ref", 32][0][0][0]
