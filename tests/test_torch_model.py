"""The port's dense forward against the reference, on reduced f32 configs
with weights made by the reference's ``Model.init`` and bridged across.

Tolerance: logits and caches allclose at atol = rtol = 1e-4 (f32 sums in
other orders); the greedy next token is equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch
from repro.models.model import Model as JModel
from repro_torch.config import get_arch as tget
from repro_torch.models.bridge import from_jax_params
from repro_torch.models.model import Model as TModel

# (arch, window): smollm (tied head), tinyllama, qwen3 (qk_norm),
# starcoder2 (gelu; a window of 8 < the prompt exercises the ring roll),
# internvl2 (untied head; the prompt after 8 patch embeddings), whisper
# (encoder frames, cross attention, LayerNorm, learned positions)
ARCHS = [("smollm-360m", None), ("tinyllama-1.1b", None), ("qwen3-8b", None),
         ("starcoder2-7b", 8), ("internvl2-2b", None), ("whisper-base", None)]


def _inputs(cfg, toks, rs):
    """The prompt batch as numpy: tokens, plus the VLM's patch
    embeddings or the audio family's encoder frames."""
    batch = {"tokens": toks}
    B = toks.shape[0]
    if cfg.family == "vlm":
        batch["patch_embeds"] = rs.normal(size=(
            B, cfg.frontend.num_embeddings, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        batch["frames"] = rs.normal(size=(
            B, cfg.encoder.num_frames, cfg.d_model)).astype(np.float32)
    return batch


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), b.float().numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("arch,window", ARCHS)
def test_prefill_and_decode_match_reference(arch, window):
    cfg = get_arch(arch).reduced()
    jm, tm = JModel(cfg), TModel(tget(arch).reduced())
    p = jm.init(jax.random.PRNGKey(3))
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, p))
    rs = np.random.default_rng(0)
    B, S, Smax = 3, 12, 24
    toks = rs.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    lens = np.array([12, 7, 9], np.int32)
    batch = _inputs(cfg, toks, rs)
    jc = jm.init_cache(B, Smax, window=window)
    tc = tm.init_cache(B, Smax, window=window, device="cpu")
    jl, jc = jm.prefill(p, {k: jnp.asarray(v) for k, v in batch.items()}, jc,
                        window=window, true_lens=jnp.asarray(lens))
    tl, tc = tm.prefill(tp, {k: torch.from_numpy(v)
                             for k, v in batch.items()}, tc,
                        window=window, true_lens=torch.from_numpy(lens))
    assert tl.dtype == torch.float32 and tl.shape == (B, cfg.vocab_size)
    _close(jl, tl)
    for step in range(3):
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)
        assert np.array_equal(nxt, tl.numpy().argmax(-1))
        jl, jc = jm.decode_step(p, jnp.asarray(nxt), jc, window=window)
        tl, tc = tm.decode_step(tp, torch.from_numpy(nxt), tc, window=window)
        _close(jl, tl)
    assert set(tc) == set(jc)
    for k in set(jc) - {"len", "pos"}:
        _close(jc[k], tc[k])
    np.testing.assert_array_equal(np.asarray(jc["len"]), tc["len"].numpy())
    np.testing.assert_array_equal(np.asarray(jc["pos"]), tc["pos"].numpy())


@pytest.mark.parametrize("arch", [a for a, _ in ARCHS])
def test_port_init_has_the_reference_layout(arch):
    cfg = get_arch(arch).reduced()
    ref = jax.eval_shape(lambda: JModel(cfg).init(jax.random.PRNGKey(0)))
    got = TModel(tget(arch).reduced()).init(seed=0, device="cpu")

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in tree.items()}
    assert shapes(got) == shapes(ref)


def test_bridge_keeps_bf16_bits():
    a = jnp.asarray(np.random.default_rng(0).normal(size=(4, 5)),
                    jnp.bfloat16)
    t = from_jax_params({"w": np.asarray(a)})["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(a.astype(jnp.float32)))
