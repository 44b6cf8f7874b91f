"""The gradients of the port's ``loss_fn`` against ``jax.grad`` of the
reference's, one reduced f32 arch of each family with weights made by
the reference's ``Model.init`` and bridged across, and the per-layer
checkpointing (``remat``) against the plain backward.

Tolerances: loss and metrics at rtol 1e-5; each gradient leaf at rtol
1e-3 and an atol of 1e-4 times the leaf's largest reference gradient
(backward sums run over other orders and lengths); remat on/off bit for
bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig, get_arch
from repro.models.model import Model as JModel
from repro.training.train_loop import loss_fn as jloss_fn
from repro_torch.config import get_arch as tget
from repro_torch.models.bridge import from_jax_params
from repro_torch.models.model import Model as TModel
from repro_torch.training.optimizer import tree_leaves
from repro_torch.training.train_loop import grads_of

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


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_loss_grads_match_jax_grad(arch):
    cfg, jm, tm, p, tp = _setup(arch)
    batch = _batch(cfg)
    (jloss, jmet), jg = jax.value_and_grad(
        lambda q: jloss_fn(jm, q, _j(batch), TC, remat=False),
        has_aux=True)(p)
    loss, met, tg = grads_of(tm, tp, _t(batch), TC, remat=False)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert set(met) == set(jmet)
    for k in met:
        np.testing.assert_allclose(float(met[k]), float(jmet[k]),
                                   rtol=1e-5, atol=1e-8)
    jleaves = jax.tree_util.tree_leaves_with_path(jg)
    tleaves = tree_leaves(tg)
    assert len(jleaves) == len(tleaves)
    for (path, j), t in zip(jleaves, tleaves):
        j = np.asarray(j)
        assert t.shape == j.shape, path
        scale = max(float(np.abs(j).max()), 1e-12)
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-3,
                                   atol=1e-4 * scale, err_msg=str(path))


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "rwkv6-3b",
                                  "zamba2-1.2b", "whisper-base"])
def test_remat_changes_no_gradient(arch):
    """Per-layer checkpointing recomputes the same floats: loss and every
    gradient leaf equal with remat on and off."""
    cfg, _, tm, _, tp = _setup(arch)
    batch = _t(_batch(cfg))
    a = grads_of(tm, tp, batch, TC, remat=False)
    b = grads_of(tm, tp, batch, TC, remat=True)
    assert float(a[0]) == float(b[0])
    for x, y in zip(tree_leaves(a[2]), tree_leaves(b[2])):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
