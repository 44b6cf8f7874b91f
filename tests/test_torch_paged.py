"""Paged KV, chunked prefill and preemption in the port, held to the
reference on the CPU with the same inputs (made with numpy) and, for the
engine, the reference's weights bridged across (reduced smollm-360m, f32).

* the paged attention primitives and the chunk-mode KV write equal the
  reference's, dropped indices and the capacity clamp included (the port's
  pool carries one trash block where the reference drops writes);
* ``prefill_chunk`` logits and caches allclose (rtol/atol 1e-5), contiguous
  and paged;
* ``BlockAllocator`` gives the same results on the same event sequence;
* engine streams (tokens and finish reasons) equal the reference engine's
  over {contiguous, paged} x {monolithic, chunked} x {overlapped,
  sequential} for ``shvs`` and ``gumbel``, and on a pool that forces
  preemption.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import SamplingConfig as JS, SHVSConfig as JSH, get_arch
from repro.engine import paged_cache as jpc
from repro.engine.engine import Engine as JEngine, EngineConfig as JECfg
from repro.engine.request import Request as JRequest
from repro.models import attention as jatt
from repro.models import transformer as jtr
from repro.models.model import Model as JModel
from repro_torch.config import (SamplingConfig as TS, SHVSConfig as TSH,
                                get_arch as tget)
from repro_torch.engine import paged_cache as tpc
from repro_torch.engine.engine import Engine as TEngine, EngineConfig as TECfg
from repro_torch.engine.request import Request as TRequest
from repro_torch.models import attention as tatt
from repro_torch.models import transformer as ttr
from repro_torch.models.bridge import from_jax_params
from repro_torch.models.model import Model as TModel

ARCH = "smollm-360m"


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _with_trash(pool, axis):
    """The port's pool: the reference's plus one trash block."""
    shape = list(pool.shape)
    shape[axis] = 1
    return np.concatenate([pool, np.zeros(shape, pool.dtype)], axis)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

NB, BS, KV, HD = 6, 4, 2, 8
TABLE = np.array([[2, 0, -1], [5, -1, -1], [1, 3, 4]], np.int32)   # (3, 3)


def test_gather_block_view_matches_reference():
    rs = np.random.default_rng(0)
    pool = rs.normal(size=(NB, BS, KV, HD)).astype(np.float32)
    want = jatt.gather_block_view(jnp.asarray(pool), jnp.asarray(TABLE), BS)
    got = tatt.gather_block_view(_t(_with_trash(pool, 0)), _t(TABLE), BS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("C,lens", [(1, [3, 0, 11]), (5, [2, 3, 9]),
                                    (4, [10, 4, 0])])
def test_flat_indices_and_scatter_match_reference_with_drops(C, lens):
    """Positions past the table, on unallocated blocks or masked out are
    dropped by the reference; the port sends them to the trash block."""
    rs = np.random.default_rng(C)
    lens = np.array(lens, np.int32)
    valid = rs.random((3, C)) < 0.8
    want_flat = np.asarray(jatt.flat_block_indices(
        jnp.asarray(TABLE), jnp.asarray(lens), jnp.asarray(valid), BS, NB))
    got_flat = tatt.flat_block_indices(_t(TABLE), _t(lens), _t(valid), BS, NB)
    np.testing.assert_array_equal(got_flat.numpy(), want_flat)
    assert (want_flat == NB * BS).any()          # the case has drops
    # per-layer and all-layer pools
    L = 2
    pool = rs.normal(size=(L, NB, BS, KV, HD)).astype(np.float32)
    new = rs.normal(size=(L, 3, C, KV, HD)).astype(np.float32)
    want = jatt.scatter_block_kv(jnp.asarray(pool), jnp.asarray(new),
                                 jnp.asarray(want_flat))
    got = tatt.scatter_block_kv(_t(_with_trash(pool, 1)), _t(new), got_flat)
    np.testing.assert_array_equal(got[:, :NB].numpy(), np.asarray(want))
    want1 = jatt.scatter_block_kv(jnp.asarray(pool[0]), jnp.asarray(new[0]),
                                  jnp.asarray(want_flat))
    got1 = tatt.scatter_block_kv(_t(_with_trash(pool[0], 0)), _t(new[0]),
                                 got_flat)
    np.testing.assert_array_equal(got1[:NB].numpy(), np.asarray(want1))


def test_attend_paged_and_chunk_cached_match_reference():
    rs = np.random.default_rng(2)
    g = 2
    kp = rs.normal(size=(NB, BS, KV, HD)).astype(np.float32)
    vp = rs.normal(size=(NB, BS, KV, HD)).astype(np.float32)
    q = rs.normal(size=(3, 1, KV, g, HD)).astype(np.float32)
    kv_len = np.array([6, 3, 12], np.int32)
    want = jatt.attend_paged(*map(jnp.asarray, (q, kp, vp, TABLE, kv_len)),
                             BS)
    got = tatt.attend_paged(_t(q), _t(_with_trash(kp, 0)),
                            _t(_with_trash(vp, 0)), _t(TABLE), _t(kv_len), BS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    C, Sc = 4, 12
    qc = rs.normal(size=(3, C, KV, g, HD)).astype(np.float32)
    ck = rs.normal(size=(3, Sc, KV, HD)).astype(np.float32)
    cv = rs.normal(size=(3, Sc, KV, HD)).astype(np.float32)
    off = np.array([0, 5, 8], np.int32)
    want = jatt.attend_chunk_cached(*map(jnp.asarray, (qc, ck, cv, off)))
    got = tatt.attend_chunk_cached(_t(qc), _t(ck), _t(cv), _t(off))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_chunk_kv_write_matches_reference_at_the_capacity_clamp():
    """A chunk slab starting past Sc - C is clamped to Sc - C (the
    reference's dynamic_update_slice); rows outside the mask keep their
    entries."""
    rs = np.random.default_rng(3)
    B, Sc, C = 4, 10, 4
    ck = rs.normal(size=(B, Sc, KV, HD)).astype(np.float32)
    cv = rs.normal(size=(B, Sc, KV, HD)).astype(np.float32)
    k = rs.normal(size=(B, C, KV, HD)).astype(np.float32)
    v = rs.normal(size=(B, C, KV, HD)).astype(np.float32)
    lens = np.array([0, 5, 8, 9], np.int32)          # 8, 9 > Sc - C
    mask = np.array([True, True, True, False])
    want = jtr._write_kv(*map(jnp.asarray, (ck, cv, k, v, lens)), "chunk",
                         jnp.asarray(mask))
    tck, tcv = _t(ck), _t(cv)
    ttr._write_kv(tck, tcv, _t(k), _t(v), _t(lens), "chunk", _t(mask))
    np.testing.assert_array_equal(tck.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(tcv.numpy(), np.asarray(want[1]))


# ---------------------------------------------------------------------------
# prefill_chunk
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    cfg = get_arch(ARCH).reduced()
    p = JModel(cfg).init(jax.random.PRNGKey(0))
    return cfg, p, from_jax_params(jax.tree_util.tree_map(np.asarray, p))


@pytest.mark.parametrize("cache", ["contiguous", "paged"])
def test_prefill_chunk_matches_reference(weights, cache):
    """Two chunks on three rows (one row outside the second chunk's mask),
    then a decode step: logits and the written K/V allclose at 1e-5."""
    cfg, jp, tp = weights
    B, S, C, bs = 3, 32, 8, 8
    rs = np.random.default_rng(4)
    jm, tm = JModel(cfg), TModel(tget(ARCH).reduced())
    if cache == "paged":
        pcfg = dict(block_size=bs, num_blocks=12, max_blocks_per_seq=S // bs)
        table = np.array([[0, 3, -1, -1], [1, 4, 6, -1], [2, 5, -1, -1]],
                         np.int32)
        jc = jpc.init_paged_cache(cfg, B, jpc.PagedCacheConfig(**pcfg))
        jc["block_table"] = jnp.asarray(table)
        tc = tpc.init_paged_cache(tm.cfg, B, tpc.PagedCacheConfig(**pcfg))
        tc["block_table"] = _t(table)
    else:
        jc, tc = jm.init_cache(B, S), tm.init_cache(B, S, device="cpu")
    steps = [(np.array([8, 8, 5], np.int32), np.array([1, 1, 1], bool)),
             (np.array([3, 8, 0], np.int32), np.array([1, 1, 0], bool))]
    for counts, mask in steps:
        toks = rs.integers(1, cfg.vocab_size, (B, C)).astype(np.int32)
        jl, jc = jm.prefill_chunk(jp, jnp.asarray(toks), jc,
                                  jnp.asarray(counts), jnp.asarray(mask))
        tl, tc = tm.prefill_chunk(tp, _t(toks), tc, _t(counts), _t(mask))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(tc["len"].numpy(),
                                      np.asarray(jc["len"]))
    nxt = rs.integers(1, cfg.vocab_size, B).astype(np.int32)
    jl, jc = jm.decode_step(jp, jnp.asarray(nxt), jc)
    tl, tc = tm.decode_step(tp, _t(nxt), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    keys = ("k_pool", "v_pool") if cache == "paged" else ("k", "v")
    for k in keys:
        got = tc[k][:, :-1] if cache == "paged" else tc[k]
        np.testing.assert_allclose(got.numpy(), np.asarray(jc[k]),
                                   rtol=1e-5, atol=1e-5)


def test_paged_write_gather_and_slot_copies_match_reference(weights):
    """``paged_write`` of a chunk with per-row counts and an inactive row,
    ``paged_gather``, and the migration pair ``gather_slot_kv`` /
    ``scatter_slot_kv`` against the reference's."""
    cfg = weights[0]
    tcfg = tget(ARCH).reduced()
    kw = dict(block_size=4, num_blocks=9, max_blocks_per_seq=4)
    jcfg, tcfg_p = jpc.PagedCacheConfig(**kw), tpc.PagedCacheConfig(**kw)
    B, C = 3, 6
    L, kv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    table = np.array([[4, 1, -1, -1], [0, 2, 7, -1], [3, -1, -1, -1]],
                     np.int32)
    jc = jpc.init_paged_cache(cfg, B, jcfg)
    jc["block_table"] = jnp.asarray(table)
    tc = tpc.init_paged_cache(tcfg, B, tcfg_p)
    tc["block_table"] = _t(table)
    rs = np.random.default_rng(6)
    k = rs.normal(size=(L, B, C, kv, hd)).astype(np.float32)
    v = rs.normal(size=(L, B, C, kv, hd)).astype(np.float32)
    lens = np.array([2, 5, 0], np.int32)
    counts = np.array([6, 4, 5], np.int32)
    active = np.array([True, True, False])
    jc = jpc.paged_write(jc, (jnp.asarray(k), jnp.asarray(v)),
                         jnp.asarray(lens), jcfg, jnp.asarray(active),
                         jnp.asarray(counts))
    tc = tpc.paged_write(tc, (_t(k), _t(v)), _t(lens), tcfg_p, _t(active),
                         _t(counts))
    for key in ("k_pool", "v_pool"):
        np.testing.assert_array_equal(tc[key][:, :-1].numpy(),
                                      np.asarray(jc[key]))
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
    for got, want in zip(tpc.paged_gather(tc, tcfg_p),
                         jpc.paged_gather(jc, jcfg)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jpc.gather_slot_kv(jc, [0, 2, 7], 9, jcfg)
    got = tpc.gather_slot_kv(tc, [0, 2, 7], 9, tcfg_p)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    jc = jpc.scatter_slot_kv(jc, [5, 6, 8], *want, jcfg)
    tc = tpc.scatter_slot_kv(tc, [5, 6, 8], *got, tcfg_p)
    for key in ("k_pool", "v_pool"):
        np.testing.assert_array_equal(tc[key][:, :-1].numpy(),
                                      np.asarray(jc[key]))


# ---------------------------------------------------------------------------
# BlockAllocator
# ---------------------------------------------------------------------------


def test_block_allocator_event_sequences_match_reference():
    rs = np.random.default_rng(5)
    kw = dict(block_size=4, num_blocks=10, max_blocks_per_seq=5)
    ja = jpc.BlockAllocator(jpc.PagedCacheConfig(**kw), 4)
    ta = tpc.BlockAllocator(tpc.PagedCacheConfig(**kw), 4)
    errors = 0
    for _ in range(300):
        op, slot, length = rs.integers(3), int(rs.integers(4)), \
            int(rs.integers(0, 26))
        outs = []
        for a in (ja, ta):
            try:
                if op == 0:
                    outs.append(a.ensure(slot, length))
                elif op == 1:
                    outs.append(a.release(slot))
                else:
                    outs.append(a.export_slot(slot))
            except RuntimeError as e:
                outs.append(f"error: {e}")
        assert outs[0] == outs[1]
        errors += isinstance(outs[0], str)
        assert ja.free == ta.free and ja.owned == ta.owned
        np.testing.assert_array_equal(ta.table(4), ja.table(4))
        assert (ja.num_free, ja.num_live) == (ta.num_free, ta.num_live)
    assert errors > 0                    # exhaustion and over-length hit


# ---------------------------------------------------------------------------
# engine streams
# ---------------------------------------------------------------------------

ENGINE = dict(max_batch=3, max_seq_len=64, k_cap=64, prompt_bucket=8,
              block_size=8, seed=3000)
MODES = [(cache, chunk, overlap) for cache in ("contiguous", "paged")
         for chunk in (0, 8) for overlap in (True, False)]


def _requests(Request, Sampling, vocab):
    """Pure-temperature rows (the gumbel kernel's tokens are committed),
    filtered rows, one greedy row, per-request seeds, and prompts of up to
    four 8-token chunks; more requests than slots."""
    rs = np.random.default_rng(8)
    out = []
    for i in range(7):
        prompt = rs.integers(1, vocab, int(rs.integers(3, 30))).tolist()
        sampling = Sampling(temperature=0.9, top_k=0 if i % 2 == 0 else 30,
                            top_p=1.0 if i % 2 == 0 else 0.95,
                            repetition_penalty=1.1,
                            seed=50 + i if i % 3 == 0 else None,
                            greedy=i == 3)
        out.append(Request(request_id=i, prompt=prompt,
                           max_new_tokens=int(rs.integers(3, 9)),
                           sampling=sampling))
    return out


def _streams(Engine, ECfg, Request, Sampling, SHVS, cfg, params, algorithm,
             reqs=None, **kw):
    ecfg = ECfg(algorithm=algorithm, shvs=SHVS(hot_size=64),
                **dict(ENGINE, **kw))
    extra = {} if Engine is JEngine else {"device": "cpu"}
    eng = Engine(cfg, params, ecfg, **extra)
    reqs = reqs or _requests(Request, Sampling, cfg.vocab_size)
    list(eng.generate(reqs))
    eng.close()
    return [(r.output, r.finish_reason) for r in reqs], eng


@pytest.fixture(scope="module")
def reference_streams(weights):
    """The reference engine's streams. ``shvs`` streams depend on neither
    the cache, the prefill mode nor the loop (the reference's own suite
    holds that), so one run serves all eight modes. ``gumbel`` keys its
    fast path on the iteration index, so the schedule matters: it is run
    per prefill mode and loop. The cache does not change the schedule
    here — the default pool holds every slot's worst case, so the block
    gate never refuses — and the reference's paged path is bit-identical
    to its contiguous one, so the contiguous run serves both caches."""
    cfg, jp, _ = weights
    run = lambda algorithm, **kw: _streams(
        JEngine, JECfg, JRequest, JS, JSH, cfg, jp, algorithm, **kw)[0]
    shared = run("shvs")
    gumbel = {(chunk, overlap): run("gumbel", prompt_chunk=chunk,
                                    overlap=overlap)
              for chunk in (0, 8) for overlap in (True, False)}
    out = {}
    for cache, chunk, overlap in MODES:
        out[("shvs", cache, chunk, overlap)] = shared
        out[("gumbel", cache, chunk, overlap)] = gumbel[(chunk, overlap)]
    return out


@pytest.mark.parametrize("cache,chunk,overlap", MODES)
@pytest.mark.parametrize("algorithm", ["shvs", "gumbel"])
def test_engine_streams_match_reference(weights, reference_streams,
                                        algorithm, cache, chunk, overlap):
    _, _, tp = weights
    got, eng = _streams(TEngine, TECfg, TRequest, TS, TSH,
                        tget(ARCH).reduced(), tp, algorithm, cache=cache,
                        prompt_chunk=chunk, overlap=overlap)
    assert got == reference_streams[(algorithm, cache, chunk, overlap)]
    assert eng.in_flight == 0
    if cache == "paged":
        assert eng.alloc.num_free == eng.pcfg.num_blocks


def _preemption_requests(Request, Sampling, vocab):
    """The reference suite's preemption trace (test_paged_engine.py)."""
    rng = np.random.default_rng(7)
    return [Request(
        request_id=i,
        prompt=rng.integers(1, vocab, int(rng.integers(4, 9))).tolist(),
        max_new_tokens=40,
        sampling=Sampling(temperature=0.9, top_k=30, top_p=0.95,
                          repetition_penalty=1.1))
        for i in range(5)]


@pytest.mark.parametrize("overlap", [True, False])
def test_preempted_streams_match_reference(weights, overlap):
    """A pool of 8 blocks of 16 forces preemption (recompute on resume):
    victims finish with the tokens they would have produced unpreempted
    (the reference's contiguous run), and every block returns."""
    cfg, jp, tp = weights
    kw = dict(max_batch=3, max_seq_len=96, block_size=16)
    want, _ = _streams(JEngine, JECfg, JRequest, JS, JSH, cfg, jp, "shvs",
                       reqs=_preemption_requests(JRequest, JS,
                                                 cfg.vocab_size), **kw)
    got, eng = _streams(TEngine, TECfg, TRequest, TS, TSH,
                        tget(ARCH).reduced(), tp, "shvs",
                        reqs=_preemption_requests(TRequest, TS,
                                                  cfg.vocab_size),
                        cache="paged", num_blocks=8, overlap=overlap, **kw)
    assert eng.scheduler.preemptions > 0, "the pool was meant to exhaust"
    assert got == want
    assert eng.alloc.num_free == eng.pcfg.num_blocks
    assert eng.alloc.num_live == 0
