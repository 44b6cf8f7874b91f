"""The port's training forward against the reference, on reduced f32
configs with weights made by the reference's ``Model.init`` and bridged
across: ``train_logits`` and its aux loss, ``attend_chunked`` and the
chunk switch of ``attention_block``, the layout of every registered
arch, and the bridge's round trips (the gradients are in
``test_torch_train_grads.py``).

Tolerances: logits allclose at rtol = atol = 1e-4 (f32 sums in other
orders); the aux loss at rtol 1e-5; chunked attention at 2e-5, as the
reference's own chunked test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ARCH_IDS, TrainConfig, get_arch
from repro.models import attention as jattn
from repro.models.model import Model as JModel
from repro.training.train_loop import loss_fn as jloss_fn
from repro_torch.config import get_arch as tget
from repro_torch.models import attention as tattn
from repro_torch.models.bridge import from_jax_params, load_npz, save_npz
from repro_torch.models.model import Model as TModel
from repro_torch.training.train_loop import loss_fn

# one arch of each family: dense, MoE, RWKV-6, Zamba2, VLM, audio
FAMILY_ARCHS = ["smollm-360m", "granite-moe-1b-a400m", "rwkv6-3b",
                "zamba2-1.2b", "internvl2-2b", "whisper-base"]
TC = TrainConfig()


@pytest.fixture(autouse=True)
def _one_thread():
    """The shapes are tiny: one intra-op thread a test, so that the
    suite's parallel workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(arch, seed=0):
    cfg = get_arch(arch).reduced()
    p = JModel(cfg).init(jax.random.PRNGKey(seed))
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, p))
    return cfg, JModel(cfg), TModel(tget(arch).reduced()), p, tp


def _batch(cfg, B=2, S=12, seed=0):
    """Numpy batch: tokens and next-token labels, plus the VLM's patch
    embeddings or the audio family's encoder frames."""
    rs = np.random.default_rng(seed)
    toks = rs.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rs.normal(size=(
            B, cfg.frontend.num_embeddings, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        batch["frames"] = rs.normal(size=(
            B, cfg.encoder.num_frames, cfg.d_model)).astype(np.float32)
    return batch


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch,remat", [(a, False) for a in FAMILY_ARCHS] + [
    ("granite-moe-1b-a400m", True), ("zamba2-1.2b", True),
    ("whisper-base", True)])
def test_train_logits_and_aux_match_reference(arch, remat):
    cfg, jm, tm, p, tp = _setup(arch)
    batch = _batch(cfg)
    jl, jaux = jm.train_logits(p, _j(batch), remat=remat)
    tl, taux = tm.train_logits(tp, _t(batch), remat=remat)
    assert tl.dtype == torch.float32
    assert tl.shape == (2, 12, cfg.vocab_size) == jl.shape
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5,
                               atol=1e-8)
    if cfg.moe is not None:
        assert float(jaux) > 0      # the load-balance loss, weighed


def test_train_logits_drop_the_patch_positions():
    """The VLM's logits cover the text only; the patches still change
    them (they sit before the text in the sequence)."""
    cfg, _, tm, _, tp = _setup("internvl2-2b")
    batch = _t(_batch(cfg))
    with_p, _ = tm.train_logits(tp, batch, remat=False)
    text_only, _ = tm.train_logits(tp, {"tokens": batch["tokens"]},
                                   remat=False)
    assert with_p.shape == text_only.shape
    assert not torch.allclose(with_p, text_only, atol=1e-3)


def _qkv(B, S, nkv, g, hd, seed=0):
    rs = np.random.default_rng(seed)
    return (rs.normal(size=(B, S, nkv, g, hd)).astype(np.float32),
            rs.normal(size=(B, S, nkv, hd)).astype(np.float32),
            rs.normal(size=(B, S, nkv, hd)).astype(np.float32))


@pytest.mark.parametrize("S,window", [(64, 0), (64, 24), (70, 0), (70, 24),
                                      (70, 5)])
def test_attend_chunked_matches_reference_and_full(S, window):
    """Blocks of 16; S = 70 pads to 80 (the pad rows sliced off); a window
    of 5 hides whole block pairs, which the port skips."""
    q, k, v = _qkv(2, S, 2, 2, 16)
    want = jattn.attend_chunked(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True, window=window,
                                chunk_q=16, chunk_k=16)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = tattn.attend_chunked(tq, tk, tv, causal=True, window=window,
                               chunk_q=16, chunk_k=16)
    full = tattn.attend_full(tq, tk, tv, causal=True, window=window)
    assert got.shape == full.shape == (2, S, 2, 2, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_attend_full_q_offset_matches_reference():
    q, k, v = _qkv(2, 24, 2, 2, 16, seed=1)
    q = q[:, :8]
    want = jattn.attend_full(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=True, window=6, q_offset=16)
    got = tattn.attend_full(*map(torch.from_numpy, (q, k, v)), causal=True,
                            window=6, q_offset=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_attention_block_switches_to_chunked_at_the_threshold():
    """``chunk_threshold=64`` at S = 100: both packages take the chunked
    path (blocks of 512, one padded block), and agree."""
    cfg, _, _, p, tp = _setup("smollm-360m")
    jp = jax.tree_util.tree_map(lambda a: a[0], p["stack"]["attn"])
    tpl = {k: v[0] for k, v in tp["stack"]["attn"].items()}
    x = np.random.default_rng(2).normal(
        size=(2, 100, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(100, dtype=np.int32), (2, 100))
    want = jattn.attention_block(jp, jnp.asarray(x), cfg, jnp.asarray(pos),
                                 chunk_threshold=64)
    got = tattn.attention_block(tpl, torch.from_numpy(x), tget(
        "smollm-360m").reduced(), torch.from_numpy(pos.copy()),
        chunk_threshold=64)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_builds_in_the_reference_layout(arch):
    """``Model`` builds all ten registered archs' reduced configs, each
    tree shaped as the reference's."""
    cfg = get_arch(arch).reduced()
    ref = jax.eval_shape(lambda: JModel(cfg).init(jax.random.PRNGKey(0)))
    got = TModel(tget(arch).reduced()).init(seed=0, device="cpu")
    shapes = lambda tree: {k: shapes(v) if isinstance(v, dict)
                           else tuple(v.shape) for k, v in tree.items()}
    assert shapes(got) == shapes(ref)


@pytest.mark.parametrize("arch,leaves", [
    ("whisper-base", ("encoder/pos", "encoder/attn/w_q", "dec_pos",
                      "stack/cross/w_k", "stack/ln_cross")),
    ("internvl2-2b", ("emb/head", "emb/tok"))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trips_the_new_leaves(tmp_path, arch, leaves, dtype):
    """The reference's tree through ``from_jax_params`` and through
    ``save_npz``/``load_npz``: every leaf kept, bf16 bit for bit."""
    cfg = get_arch(arch).reduced()
    p = JModel(cfg).init(jax.random.PRNGKey(1))
    p = jax.tree_util.tree_map(lambda a: np.asarray(a.astype(dtype)), p)
    direct = from_jax_params(p)
    save_npz(tmp_path / "w.npz", p)
    loaded = load_npz(tmp_path / "w.npz")
    flat = {"/".join(k.key for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(p)}
    assert all(name in flat for name in leaves)
    for name, want in flat.items():
        for tree in (direct, loaded):
            node = tree
            for k in name.split("/"):
                node = node[k]
            assert str(node.dtype) == f"torch.{dtype}"
            bits = np.int16 if dtype == "bfloat16" else np.int32
            np.testing.assert_array_equal(
                node.view(torch.int16 if bits is np.int16 else torch.int32)
                .numpy(), np.ascontiguousarray(want).view(bits))


def test_loss_fn_matches_reference_on_a_vlm_batch():
    """``loss_fn`` on logits that skip the patches: the labels are the
    text's."""
    cfg, jm, tm, p, tp = _setup("internvl2-2b")
    batch = _batch(cfg, seed=3)
    jtotal, _ = jloss_fn(jm, p, _j(batch), TC, remat=False)
    total, _ = loss_fn(tm, tp, _t(batch), TC, remat=False)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
