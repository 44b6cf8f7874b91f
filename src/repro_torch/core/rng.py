"""The decision plane's pre-generated uniforms, computed on the host.

The reference draws its per-row uniforms with ``jax.random`` under
``jax_threefry_partitionable=True``. This module reproduces those bits
exactly with numpy ``uint32`` arithmetic, so a request's token stream is
the same in both packages:

* ``PRNGKey(s)`` is the key ``(0, s)``;
* ``fold_in(k, d)`` is ``threefry2x32(k, (0, d))``;
* word ``i`` of a draw of shape ``(n,)`` is ``b1 ^ b2`` of
  ``threefry2x32(k, (0, i))`` (partitionable counters);
* the float is ``bitcast((bits >> 9) | 0x3F800000) - 1``.

Nonces, positions and seeds live on the host (the engine's slot arrays),
so the whole draw is a few vectorised numpy ops per step, and the engine
ships ONE (B, 3) float32 tensor to the device.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# decorrelates per-request seeded streams from the engine-keyed streams
SEED_STREAM_TAG = 0x5EEDC0DE

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _u32(x) -> np.ndarray:
    return np.asarray(x).astype(np.uint32)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k0, k1, x0, x1) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011), elementwise over
    broadcast uint32 arrays — the block cipher behind ``jax.random``."""
    args = [_u32(a) for a in (k0, k1, x0, x1)]
    shape = np.broadcast_shapes(*(a.shape for a in args))
    # flat 1-d arrays: numpy wraps array arithmetic silently, not scalars
    k0, k1, x0, x1 = (np.broadcast_to(a, shape).reshape(-1) for a in args)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0.reshape(shape), x1.reshape(shape)


def prng_key(seed) -> Tuple[np.ndarray, np.ndarray]:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: the pair (0, seed)."""
    seed = _u32(seed)
    return np.zeros_like(seed), seed


def fold_in(key, data) -> Tuple[np.ndarray, np.ndarray]:
    """``jax.random.fold_in(key, data)``."""
    data = _u32(data)
    return threefry2x32(key[0], key[1], np.zeros_like(data), data)


def uniform_bits(key, n: int) -> np.ndarray:
    """The ``n`` random words of a partitionable draw of shape ``(n,)``
    from ``key`` (arrays of shape S give words of shape S + (n,))."""
    k0 = _u32(key[0])[..., None]
    k1 = _u32(key[1])[..., None]
    b1, b2 = threefry2x32(k0, k1, np.uint32(0), np.arange(n, dtype=np.uint32))
    return b1 ^ b2


def bits_to_uniform(bits: np.ndarray) -> np.ndarray:
    """``jax.random.uniform``'s map from words to floats in [0, 1)."""
    f = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
    return f - np.float32(1.0)


def uniforms(seed: int, step: int, batch: int) -> np.ndarray:
    """(B, 3) uniforms keyed on the global iteration:
    ``uniform(fold_in(PRNGKey(seed), step), (B, 3))``."""
    key = fold_in(prng_key(seed), step)
    return bits_to_uniform(uniform_bits(key, 3 * batch)).reshape(batch, 3)


def uniforms_tagged(seed: int, nonces, positions,
                    seeds: Optional[np.ndarray] = None,
                    use_seed: Optional[np.ndarray] = None) -> np.ndarray:
    """Per-request (B, 3) uniforms. Row b draws from
    ``fold_in(fold_in(PRNGKey(seed), nonce_b), pos_b)``, or, where
    ``use_seed[b]``, from
    ``fold_in(fold_in(PRNGKey(seeds_b), SEED_STREAM_TAG), pos_b)``."""
    nonces = _u32(nonces)
    positions = _u32(positions)
    k = fold_in(fold_in(prng_key(np.full_like(nonces, seed & 0xFFFFFFFF)),
                        nonces), positions)
    if seeds is not None and use_seed is not None:
        kr = fold_in(fold_in(prng_key(_u32(seeds)),
                             np.full_like(nonces, SEED_STREAM_TAG)), positions)
        g = np.asarray(use_seed, bool)
        k = (np.where(g, kr[0], k[0]), np.where(g, kr[1], k[1]))
    return bits_to_uniform(uniform_bits(k, 3))
