"""``DecisionPlane.step`` of the port against the reference's, backend by
backend, on the same logits, penalty state, params and rng tags.

Tokens and updated histograms are equal (the uniforms are bit-equal and
every backend's draw is held to its reference); greedy and ``top_k=1``
rows agree across backends.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import SHVSConfig as JSHVS
from repro.core import penalties as jpen
from repro.core.decision_plane import DecisionPlane as JPlane
from repro.core.sampling import SamplingParams as JParams
from repro_torch.config import SHVSConfig as TSHVS
from repro_torch.core import penalties as tpen
from repro_torch.core.decision_plane import DecisionPlane as TPlane
from repro_torch.core.sampling import SamplingParams as TParams
from repro_torch.kernels import ops

B, V = 8, 512
BACKENDS = ("reference", "truncation_first", "shvs", "fused")


def _case(seed=0):
    rs = np.random.default_rng(seed)
    c = dict(
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
        nonces=rs.integers(0, 1000, B).astype(np.uint32),
        positions=rs.integers(0, 64, B).astype(np.int32),
        active=np.array([1, 1, 1, 0, 1, 1, 1, 1], bool))
    return c


_CORE = ("temperature", "top_k", "top_p", "min_p", "repetition_penalty",
         "presence_penalty", "frequency_penalty")


def _ref_step(algorithm, c, **kw):
    plane = JPlane(V, algorithm=algorithm, shvs=JSHVS(hot_size=128),
                   k_cap=64, seed=3)
    params = JParams(*[jnp.asarray(c[k]) for k in _CORE],
                     seed=jnp.asarray(c["seed"]),
                     use_seed=jnp.asarray(c["use_seed"]))
    state = jpen.PenaltyState(jnp.asarray(c["cp"]), jnp.asarray(c["co"]))
    toks, state, _ = plane.step(
        jnp.asarray(c["logits"]), state, params, jnp.int32(0),
        active=jnp.asarray(c["active"]),
        rng_tags=(jnp.asarray(c["nonces"]), jnp.asarray(c["positions"])),
        **{k: jnp.asarray(v) for k, v in kw.items()})
    return np.asarray(toks), np.asarray(state.output_counts)


def _port_step(algorithm, c, **kw):
    plane = TPlane(V, algorithm=algorithm, shvs=TSHVS(hot_size=128),
                   k_cap=64, seed=3, device="cpu")
    t = lambda k: torch.from_numpy(np.array(c[k], copy=True))
    params = TParams(*[t(k) for k in _CORE], seed=c["seed"].copy(),
                     use_seed=c["use_seed"].copy())
    state = tpen.PenaltyState(t("cp"), t("co"))
    toks, state, stats = plane.step(
        t("logits"), state, params, 0, active=t("active"),
        rng_tags=(c["nonces"], c["positions"]),
        **{k: torch.from_numpy(np.array(v, copy=True))
           for k, v in kw.items()})
    assert all(s.dim() == 0 for s in stats)
    return toks.numpy(), state.output_counts.numpy()


@pytest.mark.parametrize("algorithm", BACKENDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_step_matches_reference(algorithm, seed):
    c = _case(seed)
    want_tok, want_co = _ref_step(algorithm, c)
    got_tok, got_co = _port_step(algorithm, c)
    np.testing.assert_array_equal(got_tok, want_tok)
    np.testing.assert_array_equal(got_co, want_co)


@pytest.mark.parametrize("algorithm", ["shvs", "fused"])
def test_step_with_bias_and_allow_mask_matches_reference(algorithm):
    c = _case(2)
    rs = np.random.default_rng(9)
    bias = np.zeros((B, V), np.float32)
    bias[np.arange(B), rs.integers(0, V, B)] = 5.0
    allow = rs.random((B, V)) < 0.7
    want = _ref_step(algorithm, c, logit_bias=bias, allow_mask=allow)
    got = _port_step(algorithm, c, logit_bias=bias, allow_mask=allow)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_greedy_and_top1_rows_agree_across_backends():
    c = _case(4)
    single = (c["temperature"] <= 0) | (c["top_k"] == 1)
    toks = {a: _port_step(a, c)[0] for a in BACKENDS}
    for a in BACKENDS[1:]:
        np.testing.assert_array_equal(toks[a][single],
                                      toks["reference"][single])


def test_penalty_pass_matches_reference_rows():
    """The shell's penalty pass (penalty_scale at τ = 1) is exactly
    apply_penalties_rows, which matches the reference's."""
    c = _case(5)
    t = lambda k: torch.from_numpy(np.array(c[k], copy=True))
    rows = ("repetition_penalty", "presence_penalty", "frequency_penalty")
    want = jpen.apply_penalties_rows(
        jnp.asarray(c["logits"]),
        jpen.PenaltyState(jnp.asarray(c["cp"]), jnp.asarray(c["co"])),
        *[jnp.asarray(c[k]) for k in rows])
    state = tpen.PenaltyState(t("cp"), t("co"))
    got = tpen.apply_penalties_rows(t("logits"), state, *[t(k) for k in rows])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    shell = ops.fused_penalty_scale(t("logits"), t("cp"), t("co"),
                                    *[t(k) for k in rows], torch.ones(B))
    assert torch.equal(shell, got)


def test_histograms_skip_inactive_and_out_of_range_tokens():
    st = tpen.init_state(3, 10)
    st = tpen.update_histograms(st, torch.tensor([2, 10, -1]),
                                torch.tensor([True, True, True]))
    st = tpen.update_histograms(st, torch.tensor([2, 4, 4]),
                                torch.tensor([True, False, True]))
    want = np.zeros((3, 10), np.int32)
    want[0, 2] = 2
    want[2, 4] = 1
    np.testing.assert_array_equal(st.output_counts.numpy(), want)


def test_unregistered_backend_raises_value_error():
    with pytest.raises(ValueError, match="registered backends"):
        TPlane(V, algorithm="gumbel", device="cpu")
