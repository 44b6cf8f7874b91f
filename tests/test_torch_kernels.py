"""The port's plain kernel versions against the reference's jnp oracles,
on the CPU (the CUDA kernels against the plain versions are in
``test_torch_gpu.py``).

Inputs are made with numpy from a seed and handed to both packages.
Logits are drawn at a scale where the top-K buffer's cumulative mass stays
clear of 1.0 in f32, and V exceeds K = 256: where the buffer's mass rounds
to 1.0 (a sharp row, or a buffer that holds the whole vocabulary), ``kept``
and ``exact`` compare sums of the same terms taken in different orders
against thresholds at 1.0, and depend on that order (ROADMAP "Faults");
tokens do not.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import shvs as jshvs
from repro.kernels import ref as jref
from repro_torch.core import shvs as tshvs
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _inputs(B, V, seed, *, scale=1.5, tau_zero=0.2, extremes=False,
            hot="random"):
    rs = np.random.default_rng(seed)
    z = rs.normal(0, scale, (B, V)).astype(np.float32)
    if extremes:
        z[0, rs.integers(V)] = 1e4
        z[-1, :5] = -1e4
    sparse = lambda: (rs.integers(0, 3, (B, V)) *
                      (rs.random((B, V)) < 0.1)).astype(np.int32)
    temp = rs.uniform(0.5, 1.5, B).astype(np.float32)
    temp[rs.random(B) < tau_zero] = 0.0
    hot_mask = {"all": np.ones(V, bool), "none": np.zeros(V, bool),
                "random": rs.random(V) < 0.3}[hot]
    return dict(
        z=z, cp=sparse(), co=sparse(),
        rep=rs.uniform(1, 2, B).astype(np.float32),
        pres=rs.uniform(0, 1, B).astype(np.float32),
        freq=rs.uniform(0, 0.5, B).astype(np.float32), temp=temp,
        top_k=rs.choice([0, 0, 1, 40, 300], B).astype(np.int32),
        top_p=rs.choice([1.0, 1.0, 0.95, 0.5], B).astype(np.float32),
        min_p=rs.choice([0.0, 0.0, 0.05], B).astype(np.float32),
        u=rs.random(B).astype(np.float32), hot=hot_mask)


_PEN = ("z", "cp", "co", "rep", "pres", "freq", "temp")
_FUSED = _PEN + ("top_k", "top_p", "min_p", "u", "hot")
SWEEP = [(1, 300, "random", False), (3, 700, "all", True),
         (8, 512, "none", False), (5, 1000, "random", True),
         (2, 4097, "random", False), (6, 300, "all", False)]


@pytest.mark.parametrize("B,V,hot,ext", SWEEP)
def test_penalty_ref_matches_reference(B, V, hot, ext):
    x = _inputs(B, V, 10 + V, extremes=ext, hot=hot)
    want = np.asarray(jref.penalty_ref(*[jnp.asarray(x[k]) for k in _PEN]))
    got = tref.penalty_ref(*[_t(x[k]) for k in _PEN]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_penalty_ref_bf16_logits():
    x = _inputs(4, 512, 3)
    zb = jnp.asarray(x["z"]).astype(jnp.bfloat16)
    args = [jnp.asarray(x[k]) for k in _PEN[1:]]
    want = np.asarray(jref.penalty_ref(zb, *args))
    zt = _t(np.asarray(zb.astype(jnp.float32))).to(torch.bfloat16)
    got = tref.penalty_ref(zt, *[_t(x[k]) for k in _PEN[1:]]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("B,V,hot,ext", SWEEP)
def test_shvs_mass_ref_matches_reference(B, V, hot, ext):
    x = _inputs(B, V, 20 + V, extremes=ext, hot=hot)
    zs = np.asarray(jref.penalty_ref(*[jnp.asarray(x[k]) for k in _PEN]))
    want = jref.shvs_mass_ref(jnp.asarray(zs), jnp.asarray(x["hot"]))
    got = tref.shvs_mass_ref(_t(zs), _t(x["hot"]))
    for i, (g, w) in enumerate(zip(got, want)):
        if i in (0, 3):              # max reductions: exact
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)


@pytest.mark.parametrize("hot", ["random", "all", "none"])
def test_shvs_masses_cpu_path_matches_reference_live_path(hot):
    """On the CPU, core.shvs.shvs_masses is the reference's jnp twin
    (S_tail = S_tot - S_hot), so sampled streams match the reference's."""
    x = _inputs(6, 800, 5, hot=hot)
    idx = np.flatnonzero(x["hot"])
    want = jshvs.shvs_masses(jnp.asarray(x["z"]),
                             jshvs.make_hot_set(jnp.asarray(idx), 800))
    got = tshvs.shvs_masses(_t(x["z"]), tshvs.make_hot_set(idx, 800))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_hash_uniform_and_row_seed_bit_equal():
    rs = np.random.default_rng(7)
    for seed in (0, 0x46555345, 2 ** 32 - 1, 12345):
        b = rs.integers(0, 2 ** 24, (16, 1)).astype(np.int32)
        v = rs.integers(0, 2 ** 31 - 1, (16, 64)).astype(np.int32)
        want = np.asarray(jref._hash_uniform(seed, jnp.asarray(b),
                                             jnp.asarray(v)))
        got = tref._hash_uniform(seed, _t(b), _t(v)).numpy()
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
    u = np.concatenate([rs.random(200).astype(np.float32),
                        np.float32([0.0, 1 - 2 ** -24])])
    np.testing.assert_array_equal(
        tref._u32_from_uniform(_t(u)).numpy(),
        np.asarray(jref._u32_from_uniform(jnp.asarray(u))).astype(np.int64))


def test_topk_merge_ties_resolve_to_lowest_id():
    rs = np.random.default_rng(2)
    vals = np.full((4, 16), -np.inf, np.float32)
    idx = np.full((4, 16), 64, np.int32)
    for j in range(4):
        tile = rs.integers(-3, 3, (4, 16)).astype(np.float32)   # many ties
        tidx = np.broadcast_to(np.arange(16 * j, 16 * j + 16, dtype=np.int32),
                               (4, 16))
        wv, wi = jref.topk_merge(jnp.asarray(vals), jnp.asarray(idx),
                                 jnp.asarray(tile), jnp.asarray(tidx))
        gv, gi = tref.topk_merge(_t(vals), _t(idx).long(), _t(tile),
                                 _t(tidx).long())
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        vals, idx = np.asarray(wv), np.asarray(wi)


def test_streaming_mass_update_matches_reference():
    x = _inputs(4, 256, 9)
    m, st, sh = (np.full(4, -1e30, np.float32), np.zeros(4, np.float32),
                 np.zeros(4, np.float32))
    tm, tst, tsh = _t(m), _t(st), _t(sh)
    hot_f = x["hot"].astype(np.float32)[None, :64]
    for j in range(4):
        zs = x["z"][:, 64 * j:64 * (j + 1)]
        m, st, sh = jref.streaming_mass_update(m, st, sh, jnp.asarray(zs),
                                               jnp.asarray(hot_f))
        tm, tst, tsh = tref.streaming_mass_update(tm, tst, tsh, _t(zs),
                                                  _t(hot_f))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(m))
    np.testing.assert_allclose(tst.numpy(), np.asarray(st), rtol=1e-6)
    np.testing.assert_allclose(tsh.numpy(), np.asarray(sh), rtol=1e-6)


# the last four carry the inputs of the reference's fused ≡ unfused
# property (tests/test_property.py): ±inf entries, a row all at -1e30,
# bf16 logits, k_cap 8..200, τ = 0 and top_k = 1 rows
ADVERSARIAL = [dict(k_cap=8, bf16=False, seed=1),
               dict(k_cap=16, bf16=True, seed=2),
               dict(k_cap=64, bf16=False, seed=3),
               dict(k_cap=200, bf16=True, seed=4)]
FUSED_SWEEP = [(1, 600, 128, "random", False), (3, 700, 256, "all", True),
               (8, 512, 2048, "none", False), (5, 1000, 512, "random", True),
               (4, 2500, 2048, "random", False), (7, 333, 128, "all", True),
               (5, 384, 128, "random", ADVERSARIAL[0]),
               (4, 512, 256, "all", ADVERSARIAL[1]),
               (3, 1024, 512, "none", ADVERSARIAL[2]),
               (5, 192, 128, "random", ADVERSARIAL[3])]


def _adversarial(x, bf16: bool, seed: int):
    """The property's injections on top of ``_inputs``: three +inf and
    three -inf entries, a row all at -1e30, a τ = 0 row, a top_k = 1 row;
    bf16 logits where asked (returned as (jnp, torch) logits)."""
    rs = np.random.default_rng(seed)
    z = rs.normal(0, 4, x["z"].shape).astype(np.float32)
    B = z.shape[0]
    z.flat[rs.integers(0, z.size, 3)] = np.inf
    z.flat[rs.integers(0, z.size, 3)] = -np.inf
    z[rs.integers(0, B)] = -1e30
    x["temp"][rs.integers(0, B)] = 0.0
    x["top_k"][rs.integers(0, B)] = 1
    x["z"] = z
    if not bf16:
        return jnp.asarray(z), _t(z)
    jz = jnp.asarray(z).astype(jnp.bfloat16)
    return jz, _t(np.asarray(jz.astype(jnp.float32))).to(torch.bfloat16)


@pytest.mark.parametrize("B,V,block_v,hot,ext", FUSED_SWEEP)
def test_fused_sample_ref_matches_reference(B, V, block_v, hot, ext):
    adv = ext if isinstance(ext, dict) else None
    x = _inputs(B, V, 30 + V, extremes=adv is None and ext, hot=hot)
    k_cap = 256 if adv is None else adv["k_cap"]
    jargs = [jnp.asarray(x[k]) for k in _FUSED]
    targs = [_t(x[k]) for k in _FUSED]
    if adv is not None:
        jargs[0], targs[0] = _adversarial(x, adv["bf16"], adv["seed"])
        jargs[1:] = [jnp.asarray(x[k]) for k in _FUSED[1:]]
        targs[1:] = [_t(x[k]) for k in _FUSED[1:]]
    want = jref.fused_sample_ref(*jargs, k_cap=k_cap, block_v=block_v)
    got = tref.fused_sample_ref(*targs, k_cap=k_cap, block_v=block_v)
    for i in (0, 1, 3):                          # tokens, exact, kept
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-6)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
    assert ((got[0] >= 0) & (got[0] < V)).all()


@pytest.mark.parametrize("V,scale", [(512, 4.0), (128, 1.5)])
def test_fused_sample_ref_saturated_rows_keep_tokens(V, scale):
    """Where the buffer's cumulative mass rounds to 1.0 (sharp rows, or
    V <= K), tokens still match the reference; kept/exact may not."""
    x = _inputs(6, V, 77, scale=scale)
    x["temp"] = np.float32([0.3, 0.5, 1.0, 0.0, 0.4, 1.5])
    want = jref.fused_sample_ref(*[jnp.asarray(x[k]) for k in _FUSED],
                                 k_cap=256, block_v=128)
    got = tref.fused_sample_ref(*[_t(x[k]) for k in _FUSED], k_cap=256,
                                block_v=128)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-6)


def test_ops_dispatch_cpu_tensors_to_plain_versions():
    ops.reset_launch_counts()
    x = _inputs(3, 300, 4)
    z = ops.fused_penalty_scale(*[_t(x[k]) for k in _PEN])
    torch.testing.assert_close(z, tref.penalty_ref(*[_t(x[k]) for k in _PEN]),
                               rtol=0, atol=0)
    ops.fused_shvs_masses(z, _t(x["hot"]))
    np.testing.assert_array_equal(ops.fused_gumbel_argmax(z, 7).numpy(),
                                  tref.gumbel_argmax_ref(z, 7).numpy())
    assert ops.launch_counts() == {"penalty_scale": 0, "shvs_masses": 0,
                                   "fused_sample": 0, "gumbel_argmax": 0}
