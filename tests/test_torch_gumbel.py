"""The port's ``gumbel`` path against the reference's, on the CPU: the plain
``gumbel_argmax_ref`` against the reference oracle and its interpret-mode
Pallas kernel, the two inputs where the reference hash gives u == 1.0,
and ``GumbelBackend.step`` against the reference backend at an engine
seed whose ``seed32`` wraps in int32. Tokens are compared exactly, stats
to 1e-6. (The CUDA kernel against the plain version is in
``test_torch_gpu.py``.)
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sampler_backend import make_backend as jmake
from repro.core.sampling import SamplingParams as JParams
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.sampler_backend import make_backend as tmake
from repro_torch.core.sampling import SamplingParams as TParams
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

# the reference kernel suite's shapes (tests/test_kernels.py SHAPES)
SHAPES = [(1, 128), (4, 512), (8, 1024), (3, 700), (16, 2048), (5, 4096)]
SEEDS = (0, 42, 1234)


def _z(B, V, seed=3):
    return np.random.default_rng(seed).normal(0, 2, (B, V)).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_version_matches_reference_oracle(shape):
    z = _z(*shape)
    for seed in SEEDS:
        want = np.asarray(jref.gumbel_argmax_ref(jnp.asarray(z), seed))
        got = ops.fused_gumbel_argmax(torch.from_numpy(z), seed)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [s for s in SHAPES if s[1] % 512 == 0])
def test_plain_version_matches_interpret_mode_kernel(shape):
    """Where V is a multiple of the kernel's 512-wide tile, the reference's
    padded, tiled Pallas kernel and its oracle agree; so does the port."""
    z = _z(*shape, seed=5)
    for seed in SEEDS:
        want = np.asarray(jops.fused_gumbel_argmax(jnp.asarray(z), seed))
        got = tref.gumbel_argmax_ref(torch.from_numpy(z), seed)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("V,seed,hot,want", [(512, 11408, 7, 420),
                                             (49152, 324, None, 32466)])
def test_u_equal_one_wins_as_in_the_reference(V, seed, hot, want):
    """The reference hash rounds its top 128 values to u = 1.0, so G = +inf
    and that column wins whatever the logits; the port reproduces it."""
    z = np.zeros((1, V), np.float32)
    if hot is not None:
        z[0, hot] = 60.0
    ref_tok = int(jref.gumbel_argmax_ref(jnp.asarray(z), seed)[0])
    got = int(tref.gumbel_argmax_ref(torch.from_numpy(z), seed)[0])
    assert ref_tok == got == want
    u = tref._hash_uniform(seed, torch.tensor(0), torch.tensor(want))
    assert float(u) == 1.0


def test_nan_and_ties_follow_jnp_argmax():
    z = np.array([[1.0, 3.0, 3.0, 0.0], [0.0, np.nan, 5.0, np.nan]],
                 np.float32)
    # g identical across columns only if u is; compare against the oracle
    for seed in SEEDS:
        want = np.asarray(jref.gumbel_argmax_ref(jnp.asarray(z), seed))
        got = tref.gumbel_argmax_ref(torch.from_numpy(z), seed).numpy()
        np.testing.assert_array_equal(got, want)
        assert got[1] == 1                       # the first NaN wins


B, V = 8, 512
_CORE = ("temperature", "top_k", "top_p", "min_p", "repetition_penalty",
         "presence_penalty", "frequency_penalty")


def _case(seed):
    """Greedy (τ = 0), filtered and unfiltered rows."""
    rs = np.random.default_rng(seed)
    return dict(
        z=rs.normal(0, 1.5, (B, V)).astype(np.float32),
        temperature=np.float32([0.8, 0.0, 1.0, 0.7, 1.2, 0.0, 0.9, 1.3]),
        top_k=np.int32([0, 0, 40, 0, 0, 5, 0, 1]),
        top_p=np.float32([1.0, 1.0, 1.0, 0.9, 1.0, 1.0, 1.0, 1.0]),
        min_p=np.float32([0.0, 0.0, 0.0, 0.0, 0.05, 0.0, 0.0, 0.0]),
        repetition_penalty=np.ones(B, np.float32),
        presence_penalty=np.zeros(B, np.float32),
        frequency_penalty=np.zeros(B, np.float32),
        u=rs.random((B, 3)).astype(np.float32))


@pytest.mark.parametrize("seed,step", [(0, 0), (1, 7), (2, 123456)])
def test_backend_step_matches_reference(seed, step, monkeypatch):
    """Engine seed 3000: ``seed32 = 3000 * 1000003 + step`` wraps in int32
    in the reference (-1294958289 at step 7); the kernel gets its uint32
    bits."""
    c = _case(seed)
    jb = jmake("gumbel", vocab_size=V, k_cap=64, seed=3000)
    jparams = JParams(*[jnp.asarray(c[k]) for k in _CORE])
    jtok, jstats = jb.step(jnp.asarray(c["z"]), jparams, jnp.asarray(c["u"]),
                           step_idx=jnp.asarray(step, jnp.int32))
    seen = []
    real = ops.fused_gumbel_argmax
    monkeypatch.setattr(ops, "fused_gumbel_argmax",
                        lambda z, s: seen.append(s) or real(z, s))
    tb = tmake("gumbel", vocab_size=V, k_cap=64, seed=3000, device="cpu")
    tparams = TParams(*[torch.from_numpy(c[k].copy()) for k in _CORE])
    ttok, tstats = tb.step(torch.from_numpy(c["z"]), tparams,
                           torch.from_numpy(c["u"]), step_idx=step)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    for a, b in zip(tstats, jstats):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6, atol=1e-6)
    want_seed = int(np.asarray(jnp.asarray(3000, jnp.int32) * 1000003 +
                               jnp.asarray(step, jnp.int32))) & 0xFFFFFFFF
    assert seen == [want_seed]
    if step == 7:
        assert want_seed == 3000009007
