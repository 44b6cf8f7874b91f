"""Degenerate decision rows (``tests/torch_degenerate_rows.py``): the
port against the reference on the CPU.

Filters that keep nothing (``top_p <= 0``, ``min_p > 1``), ``min_p = 1``,
``temperature`` 1e-30 and NaN, ``repetition_penalty`` 0, a NaN column, an
all-NaN row, an all -inf row, a +inf column, and rows with fewer finite
values than K. The port returns what the reference returns on every such
row; it rejects none of them, as the reference does not.

* ``DecisionPlane.step`` through all five backends: tokens and updated
  histograms equal, case by case (the cases run as one batch a backend:
  rows are decided independently, and the reference's eager ops then
  compile once).
* ``kernels/ref.py:fused_sample_ref`` against the reference's at k_cap 64
  and 256: tokens, ``exact`` and ``kept`` equal, ``alpha`` within 1e-6
  (NaN where the reference's is).
* The host sampler pool (2 workers, ``fused``) against the reference's.
* The gateway: a port replica and a reference replica (the reference's
  smoke model, ``fused``) each answer a ``"top_p": 0`` request over HTTP
  with 200 and equal streams, the port's equal to its greedy twin's.
"""
import asyncio
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import SHVSConfig as JSH
from repro.core import penalties as jpen
from repro.core.decision_plane import DecisionPlane as JPlane
from repro.core.host_sampler import HostSamplerPool as JPool
from repro.core.sampling import SamplingParams as JParams
from repro.engine import Engine as JEngine, EngineConfig as JECfg
from repro.gateway import (GatewayServer as JGateway,
                           ReplicaFleet as JFleet, smoke as jsmoke)
from repro.gateway.client import stream_completion as jstream
from repro.kernels import ref as jref
from repro.models.model import Model as JModel
from repro_torch.config import SHVSConfig as TSH
from repro_torch.core import penalties as tpen
from repro_torch.core.decision_plane import DecisionPlane as TPlane
from repro_torch.core.host_sampler import HostSamplerPool
from repro_torch.core.sampling import SamplingParams as TParams
from repro_torch.engine import Engine as TEngine, EngineConfig as TECfg
from repro_torch.gateway import (GatewayServer, ReplicaFleet,
                                 smoke as tsmoke)
from repro_torch.gateway.client import stream_completion
from repro_torch.kernels import ref as tref
from repro_torch.models.bridge import from_jax_params
from torch_degenerate_rows import CASES, NAN_ROW, case

B, V = 8, 512
BACKENDS = ("reference", "truncation_first", "shvs", "fused", "gumbel")
_CORE = ("temperature", "top_k", "top_p", "min_p", "repetition_penalty",
         "presence_penalty", "frequency_penalty")
_FUSED = ("logits", "cp", "co", "repetition_penalty", "presence_penalty",
          "frequency_penalty", "temperature", "top_k", "top_p", "min_p", "u",
          "hot")


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


@functools.lru_cache(maxsize=None)
def _stacked():
    """Every case's B rows, one case after another."""
    cs = [case(name, B, V, seed=0) for name in CASES]
    return {k: np.concatenate([c[k] for c in cs]) if k != "hot" else
            cs[0]["hot"] for k in cs[0]}


def _rows(name):
    i = CASES.index(name)
    return slice(i * B, (i + 1) * B)


@functools.lru_cache(maxsize=None)
def _plane_steps(algorithm):
    """(reference tokens, histograms), (port tokens, histograms) of one
    ``DecisionPlane.step`` over every case's rows. The reference's step
    runs jitted, as its engine runs it (one compile, not one an op)."""
    c = _stacked()
    n = c["logits"].shape[0]
    jplane = JPlane(V, algorithm=algorithm, shvs=JSH(hot_size=128),
                    k_cap=64, seed=3)

    @jax.jit
    def jstep(logits, cp, co, core, seed, use_seed, active, tags):
        tok, state, _ = jplane.step(
            logits, jpen.PenaltyState(cp, co),
            JParams(*core, seed=seed, use_seed=use_seed), jnp.int32(0),
            active=active, rng_tags=tags)
        return tok, state.output_counts

    j = {k: jnp.asarray(v) for k, v in c.items()}
    jtok, jco = jstep(j["logits"], j["cp"], j["co"],
                      tuple(j[k] for k in _CORE), j["seed"], j["use_seed"],
                      j["active"], (j["nonces"], j["positions"]))
    tplane = TPlane(V, algorithm=algorithm, shvs=TSH(hot_size=128),
                    k_cap=64, seed=3, device="cpu")
    tparams = TParams(*[_t(c[k]) for k in _CORE], seed=c["seed"].copy(),
                      use_seed=c["use_seed"].copy())
    ttok, tstate, _ = tplane.step(
        _t(c["logits"]), tpen.PenaltyState(_t(c["cp"]), _t(c["co"])),
        tparams, 0, active=_t(c["active"]),
        rng_tags=(c["nonces"], c["positions"]))
    assert ttok.shape == (n,)
    return ((np.asarray(jtok), np.asarray(jco)),
            (ttok.numpy(), tstate.output_counts.numpy()))


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("algorithm", BACKENDS)
def test_plane_step_matches_reference(algorithm, name):
    (want, want_co), (got, got_co) = _plane_steps(algorithm)
    rows = _rows(name)
    np.testing.assert_array_equal(got[rows], want[rows])
    np.testing.assert_array_equal(got_co[rows], want_co[rows])


def test_nan_rows_give_the_reference_tokens():
    """The rows on which the port's NaN-first sorts departed: a NaN in
    column 7 of ``_case(0)``'s rows (``fused``: every row; ``reference``:
    the rows whose top-k cut the NaN), and the all-NaN row, whose fused
    draw is the buffer's (-inf, Vp) entry clamped to V - 1."""
    fused = _plane_steps("fused")[1][0]
    reference = _plane_steps("reference")[1][0]
    np.testing.assert_array_equal(
        fused[_rows("nan_first")], [244, 421, 27, 228, 160, 285, 179, 217])
    np.testing.assert_array_equal(
        reference[_rows("nan_first")][[0, 2, 7]], [219, 27, 217])
    assert fused[_rows("nan_row")][NAN_ROW] == V - 1


@pytest.mark.parametrize("k_cap", [64, 256])
@pytest.mark.parametrize("name", CASES)
def test_fused_sample_ref_matches_reference(name, k_cap):
    c = case(name, B, V, seed=CASES.index(name))
    want = jref.fused_sample_ref(*[jnp.asarray(c[k]) for k in _FUSED],
                                 k_cap=k_cap, block_v=128)
    got = tref.fused_sample_ref(*[_t(c[k]) for k in _FUSED], k_cap=k_cap,
                                block_v=128)
    for i in (0, 1, 3):                          # tokens, exact, kept
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-6)


def test_host_pool_matches_reference_pool():
    c = case("nan_mid", B, V, seed=5)
    bias = np.zeros((B, V), np.float32)
    jparams = JParams(*[jnp.asarray(c[k]) for k in _CORE],
                      seed=jnp.asarray(c["seed"]),
                      use_seed=jnp.asarray(c["use_seed"]))
    tparams = TParams(*[_t(c[k]) for k in _CORE], seed=c["seed"].copy(),
                      use_seed=c["use_seed"].copy())
    jpool = JPool(JPlane(V, algorithm="fused", shvs=JSH(hot_size=128),
                         k_cap=64, seed=3), 2)
    tpool = HostSamplerPool(TPlane(V, algorithm="fused",
                                   shvs=TSH(hot_size=128), k_cap=64, seed=3,
                                   device="cpu"), 2)
    try:
        want = jpool.submit(
            jnp.asarray(c["logits"]),
            jpen.PenaltyState(jnp.asarray(c["cp"]), jnp.asarray(c["co"])),
            jparams, jnp.asarray(bias), c["nonces"].copy(),
            c["positions"].copy(), 5, c["active"].copy()).result()
        got = tpool.submit(
            _t(c["logits"]), tpen.PenaltyState(_t(c["cp"]), _t(c["co"])),
            tparams, _t(bias), c["nonces"].copy(), c["positions"].copy(), 5,
            c["active"].copy()).result()
    finally:
        jpool.close()
        tpool.close()
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    for g, w in zip(got.state, want.state):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for k in ("accept_rate", "alpha_mean", "fallback_rate"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k),
                                   rtol=1e-6)


def _payload(**kw):
    return {"prompt": "the quick brown fox", "max_tokens": 6,
            "temperature": 0.9, "repetition_penalty": 1.1, "seed": 11, **kw}


async def _ask(gw, stream, payloads):
    """``payloads`` one after another over live HTTP/SSE from ``gw``."""
    await gw.serve(port=0)
    try:
        return [await stream(gw.host, gw.port, p) for p in payloads]
    finally:
        await gw.shutdown()


def test_gateway_top_p_zero_streams_match_reference():
    """``"top_p": 0`` keeps nothing, so the draw is the top penalised
    logit: the stream is the greedy stream, from either package."""
    jparams = jax.jit(JModel(jsmoke.smoke_model()).init)(
        jax.random.PRNGKey(0))
    cfg = dict(max_batch=2, max_seq_len=32, algorithm="fused", k_cap=256,
               overlap=True, sampler_mode="device")
    jeng = JEngine(jsmoke.smoke_model(), jparams, JECfg(
        shvs=JSH(hot_size=jsmoke.VOCAB // 4), **cfg))
    teng = TEngine(tsmoke.smoke_model(),
                   from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                          jparams)),
                   TECfg(shvs=TSH(hot_size=tsmoke.VOCAB // 4), **cfg),
                   device="cpu")
    (want,) = asyncio.run(_ask(JGateway(JFleet([jeng], capacity=2)),
                               jstream, [_payload(top_p=0)]))
    got, greedy = asyncio.run(_ask(
        GatewayServer(ReplicaFleet([teng], capacity=2)), stream_completion,
        [_payload(top_p=0), _payload(temperature=0.0)]))
    for res in (want, got, greedy):
        assert res.status == 200 and res.error is None, res.error
        assert len(res.tokens) == 6
    assert got.tokens == want.tokens
    assert got.tokens == greedy.tokens
