"""The port's host-side threefry uniforms are bit-equal to jax.random."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro  # noqa: F401  (jax_threefry_partitionable, as the engine runs)
from repro.core.decision_plane import DecisionPlane
from repro_torch.core import rng


def _u32(rs, n):
    return rs.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def test_key_and_fold_in_match_jax():
    rs = np.random.default_rng(0)
    for s, d in zip(_u32(rs, 50), _u32(rs, 50)):
        want = np.asarray(jax.random.key_data(
            jax.random.fold_in(jax.random.PRNGKey(int(s)), int(d))))
        got = rng.fold_in(rng.prng_key(s), d)
        assert [int(got[0]), int(got[1])] == want.tolist()


@pytest.mark.parametrize("with_seeds", [False, True])
def test_uniforms_tagged_bit_equal(with_seeds):
    rs = np.random.default_rng(1 + with_seeds)
    total = 0
    for engine_seed in (0, 1, 7, 123456, 2 ** 31 - 1, 4242, 99, 5):
        nonces, pos, seeds = _u32(rs, 32), _u32(rs, 32), _u32(rs, 32)
        use = rs.random(32) < 0.5
        plane = DecisionPlane(64, algorithm="reference", seed=engine_seed)
        if with_seeds:
            want = plane.uniforms_tagged(jnp.asarray(nonces), jnp.asarray(pos),
                                         seeds=jnp.asarray(seeds),
                                         use_seed=jnp.asarray(use))
            got = rng.uniforms_tagged(engine_seed, nonces, pos, seeds, use)
        else:
            want = plane.uniforms_tagged(jnp.asarray(nonces), jnp.asarray(pos))
            got = rng.uniforms_tagged(engine_seed, nonces, pos)
        assert got.shape == (32, 3) and got.dtype == np.float32
        np.testing.assert_array_equal(_bits(got), _bits(want))
        total += 32
    assert total >= 200


def test_uniforms_per_step_bit_equal():
    plane = DecisionPlane(64, algorithm="reference", seed=11)
    for step in (0, 1, 17, 2 ** 31 + 5):
        for batch in (1, 3, 8):
            np.testing.assert_array_equal(
                _bits(rng.uniforms(11, step, batch)),
                _bits(plane.uniforms(step, batch)))
