"""The port's training substrate (``repro_torch.training``) against the
reference's: every test of ``tests/test_training.py`` mirrored on the
port, AdamW steps and ``lr_schedule`` against the reference's, the
synthetic data bit for bit, checkpoints crossing between the packages,
and a short ``Trainer.fit`` from bridged parameters.

Tolerances: AdamW parameters and moments allclose at rtol 1e-5 (f32
``pow``/``cos``/``sqrt`` may differ in the last ulp); the learning rate
at rtol 1e-6; the ``fit`` history (loss, ce, grad norm) at rtol 1e-4,
five steps of f32 training compounding those ulps. Data and checkpoints
are compared bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig, get_arch
from repro.models.model import Model as JModel
from repro.training import Trainer as JTrainer
from repro.training import checkpoint as jckpt
from repro.training import data as jdata
from repro.training import optimizer as jopt
from repro_torch.config import get_arch as tget
from repro_torch.models.bridge import from_jax_params
from repro_torch.models.model import Model
from repro_torch.training import Trainer
from repro_torch.training.checkpoint import (restore_checkpoint,
                                             save_checkpoint)
from repro_torch.training.data import (DataConfig, PrefetchLoader,
                                       SyntheticDataset)
from repro_torch.training.optimizer import (AdamWState, adamw_init,
                                            adamw_update,
                                            clip_by_global_norm,
                                            lr_schedule, tree_leaves)


@pytest.fixture(autouse=True)
def _one_thread():
    """The shapes are tiny: one intra-op thread a test, so that the
    suite's parallel workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ref_params(arch, seed=0, dtype=None):
    p = JModel(get_arch(arch).reduced()).init(jax.random.PRNGKey(seed))
    if dtype is not None:
        p = jax.tree_util.tree_map(lambda a: a.astype(dtype), p)
    return p


def _port_init(arch, dtype=None):
    """The port's seeded init of the reduced arch, as a restore template."""
    cfg = tget(arch).reduced()
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    return Model(cfg).init(seed=0, device="cpu")


# -- tests/test_training.py, on the port ------------------------------------


def test_adamw_first_step_is_signed_lr():
    """After one step with huge beta corrections, |Δp| ≈ lr · sign(g)."""
    cfg = TrainConfig(learning_rate=1e-2, weight_decay=0.0, grad_clip=0.0,
                      warmup_steps=0, total_steps=10**9)
    p = {"w": torch.zeros((4, 4))}
    g = {"w": torch.from_numpy(np.random.default_rng(0).normal(
        size=(4, 4)).astype(np.float32))}
    st = adamw_init(p)
    p2, st2, m = adamw_update(p, g, st, cfg)
    delta = p2["w"].numpy()
    np.testing.assert_allclose(np.abs(delta),
                               float(m["lr"]) * np.ones_like(delta), rtol=1e-3)
    np.testing.assert_array_equal(np.sign(delta), -np.sign(g["w"].numpy()))


def test_grad_clip():
    g = {"a": torch.full((10,), 10.0)}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert float(norm) > 1.0
    total = torch.sqrt(torch.sum(torch.square(clipped["a"])))
    np.testing.assert_allclose(float(total), 1.0, rtol=1e-5)


def test_lr_schedule_shape():
    cfg = TrainConfig(learning_rate=1e-3, warmup_steps=10, total_steps=100)
    lrs = [float(lr_schedule(cfg, torch.tensor(s))) for s in range(0, 101, 10)]
    assert lrs[0] == 0.0
    assert abs(lrs[1] - 1e-3) < 1e-9          # end of warmup
    assert lrs[-1] < lrs[1]                   # decayed
    assert lrs[-1] >= 0.1 * 1e-3 * 0.99       # floor at 10%


def test_weight_decay_applies_to_matrices_only():
    cfg = TrainConfig(learning_rate=1e-2, weight_decay=1.0, grad_clip=0.0,
                      warmup_steps=0, total_steps=10**9)
    p = {"mat": torch.ones((2, 2)), "vec": torch.ones((2,))}
    g = {"mat": torch.zeros((2, 2)), "vec": torch.zeros((2,))}
    st = adamw_init(p)
    p2, _, _ = adamw_update(p, g, st, cfg)
    assert float(p2["mat"][0, 0]) < 1.0       # decayed
    np.testing.assert_allclose(p2["vec"].numpy(), 1.0)  # untouched


def test_loss_decreases_end_to_end(tmp_path):
    cfg = tget("smollm-360m").reduced()
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=5, total_steps=40)
    tr = Trainer(cfg, tc, device="cpu")
    ds = SyntheticDataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=24,
                                     batch_size=4))
    loader = PrefetchLoader(ds)
    try:
        hist = tr.fit(loader, steps=25, log_every=5, log_fn=None)
    finally:
        loader.close()
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert all(not t.requires_grad for t in tree_leaves(tr.params))
    # checkpoint round-trip preserves every leaf
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, tr.params, tr.opt_state, step=25)
    p2, o2, step = restore_checkpoint(path, tr.params, tr.opt_state)
    assert step == 25
    for a, b in zip(tree_leaves(tr.params), tree_leaves(p2)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert int(o2.step) == int(tr.opt_state.step) == 25
    for a, b in zip(tree_leaves(tr.opt_state.nu), tree_leaves(o2.nu)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_data_pipeline_zipf_marginals():
    ds = SyntheticDataset(DataConfig(vocab_size=128, seq_len=64, batch_size=8,
                                     zipf_s=1.3, repeat_prob=0.0))
    batch = ds.sample_batch()
    toks = batch["tokens"].ravel()
    counts = np.bincount(toks, minlength=128)
    # head tokens strictly more frequent than tail on average
    assert counts[:8].mean() > counts[64:].mean()
    assert batch["tokens"].shape == (8, 64)
    # labels are next-token shifted
    full_first = batch["tokens"][0, 1:]
    np.testing.assert_array_equal(full_first, batch["labels"][0, :-1])


def test_prefetch_loader_delivers():
    ds = SyntheticDataset(DataConfig(vocab_size=32, seq_len=8, batch_size=2))
    loader = PrefetchLoader(ds, depth=2)
    try:
        batches = [next(iter(loader)) for _ in range(3)]
    finally:
        loader.close()
    assert all(b["tokens"].shape == (2, 8) for b in batches)


# -- against the reference ---------------------------------------------------


def test_lr_schedule_matches_reference():
    cfg = TrainConfig(learning_rate=3e-4, warmup_steps=7, total_steps=50)
    for s in (0, 1, 6, 7, 8, 20, 49, 50, 60):
        np.testing.assert_allclose(
            float(lr_schedule(cfg, torch.tensor(s, dtype=torch.int32))),
            float(jopt.lr_schedule(cfg, jnp.asarray(s, jnp.int32))),
            rtol=1e-6)


@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-1b-a400m"])
def test_adamw_update_matches_reference(arch):
    """Two AdamW steps (clipping on, decay on the matrices) over the
    reduced model's tree with seeded gradients: params, mu, nu, step, the
    learning rate and the gradient norm."""
    cfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    p = _ref_params(arch)
    rs = np.random.default_rng(5)
    grads = [jax.tree_util.tree_map(
        lambda a: rs.normal(scale=s, size=a.shape).astype(np.float32), p)
        for s in (0.5, 0.01)]
    jp, jst = p, jopt.adamw_init(p)
    tp = from_jax_params(_np(p))
    tst = adamw_init(tp)
    for g in grads:
        jp, jst, jm = jopt.adamw_update(jp, jax.tree_util.tree_map(
            jnp.asarray, g), jst, cfg)
        tp, tst, tm = adamw_update(tp, from_jax_params(g), tst, cfg)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
    assert int(tst.step) == int(jst.step) == 2
    for jtree, ttree in ((jp, tp), (jst.mu, tst.mu), (jst.nu, tst.nu)):
        jl = jax.tree_util.tree_leaves(jtree)
        tl = tree_leaves(ttree)
        assert len(jl) == len(tl)
        for a, b in zip(jl, tl):
            assert b.dtype == torch.float32
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                       atol=1e-8)


@pytest.mark.parametrize("kw", [
    dict(vocab_size=512, seq_len=24, batch_size=4),
    dict(vocab_size=49152, seq_len=128, batch_size=8, seed=3),
    dict(vocab_size=100, seq_len=7, batch_size=3, zipf_s=1.3,
         repeat_prob=0.5, seed=11)])
def test_dataset_batches_equal_reference_bitwise(kw):
    mine = SyntheticDataset(DataConfig(**kw))
    ref = jdata.SyntheticDataset(jdata.DataConfig(**kw))
    np.testing.assert_array_equal(mine.probs, ref.probs)
    for _ in range(3):
        a, b = mine.sample_batch(), ref.sample_batch()
        assert set(a) == set(b) == {"tokens", "labels"}
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def _opt_f32(p):
    """An AdamW state with seeded moments and a step of 3."""
    rs = np.random.default_rng(9)
    rnd = lambda a: jnp.asarray(rs.normal(size=a.shape), jnp.float32)
    return jopt.AdamWState(step=jnp.asarray(3, jnp.int32),
                           mu=jax.tree_util.tree_map(rnd, p),
                           nu=jax.tree_util.tree_map(rnd, p))


def _same(tree_a, tree_b):
    la, lb = tree_leaves(tree_a), jax.tree_util.tree_leaves(tree_b)
    assert len(la) == len(lb)
    for a, b in zip(la, lb):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_checkpoint_from_the_port_restores_in_the_reference(tmp_path):
    p = _ref_params("granite-moe-1b-a400m", seed=2)
    opt = _opt_f32(p)
    tp = from_jax_params(_np(p))
    topt = AdamWState(step=torch.tensor(3, dtype=torch.int32),
                      mu=from_jax_params(_np(opt.mu)),
                      nu=from_jax_params(_np(opt.nu)))
    save_checkpoint(str(tmp_path), tp, topt, step=3, metadata={"a": 1})
    zeros = jax.tree_util.tree_map(jnp.zeros_like, p)
    jp, jo, step = jckpt.restore_checkpoint(
        str(tmp_path), zeros, jopt.adamw_init(zeros))
    assert step == 3
    _same(tp, jp)
    _same(topt.mu, jo.mu)
    _same(topt.nu, jo.nu)
    assert int(jo.step) == 3
    with np.load(tmp_path / "opt.npz") as f:
        assert set(f.files) == set(jckpt._flatten(opt))


def test_checkpoint_from_the_reference_restores_in_the_port(tmp_path):
    p = _ref_params("whisper-base", seed=4)
    opt = _opt_f32(p)
    jckpt.save_checkpoint(str(tmp_path), p, opt, step=7)
    tmpl = _port_init("whisper-base")
    tp, topt, step = restore_checkpoint(str(tmp_path), tmpl,
                                        adamw_init(tmpl))
    assert step == 7 and int(topt.step) == 3
    assert topt.step.dtype == torch.int32
    _same(tp, p)
    _same(topt.mu, opt.mu)
    _same(topt.nu, opt.nu)


def test_bf16_checkpoint_from_the_reference_restores_bit_for_bit(tmp_path):
    """The reference writes a bf16 leaf as 2-byte raw entries; the port
    reads them as bf16 bits, and writes the same entries itself."""
    p = _ref_params("smollm-360m", seed=5, dtype=jnp.bfloat16)
    jckpt.save_checkpoint(str(tmp_path / "ref"), p, step=1)
    tp, _, _ = restore_checkpoint(str(tmp_path / "ref"),
                                  _port_init("smollm-360m", "bfloat16"))
    for a, b in zip(tree_leaves(tp), jax.tree_util.tree_leaves(p)):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            a.view(torch.int16).numpy(), np.asarray(b).view(np.int16))
    save_checkpoint(str(tmp_path / "port"), tp, step=1)
    with np.load(tmp_path / "ref" / "params.npz") as r, \
            np.load(tmp_path / "port" / "params.npz") as t:
        assert set(r.files) == set(t.files)
        for k in r.files:
            assert t[k].dtype.kind == r[k].dtype.kind == "V"
            assert t[k].tobytes() == r[k].tobytes()


def test_reference_restore_of_bf16_raises_fault_8(tmp_path):
    """ROADMAP Fault 8: the reference cannot restore its own bf16 leaf."""
    p = {"a": jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3)}
    jckpt.save_checkpoint(str(tmp_path), p)
    with pytest.raises(ValueError, match="cast"):
        jckpt.restore_checkpoint(str(tmp_path), p)
    tp, _, _ = restore_checkpoint(
        str(tmp_path), {"a": torch.zeros((2, 3), dtype=torch.bfloat16)})
    np.testing.assert_array_equal(tp["a"].float().numpy(),
                                  np.arange(6).reshape(2, 3))


def test_fit_history_matches_reference():
    """Five logged steps of ``Trainer.fit`` on reduced smollm-360m, both
    packages from the reference's init and the same batches."""
    arch = "smollm-360m"
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10)
    jt = JTrainer(get_arch(arch).reduced(), tc, seed=0)
    tt = Trainer(tget(arch).reduced(), tc, seed=0, device="cpu")
    tt.params = from_jax_params(_np(jt.params))
    tt.opt_state = adamw_init(tt.params)
    ds = SyntheticDataset(DataConfig(vocab_size=512, seq_len=16,
                                     batch_size=4, seed=1))
    batches = [ds.sample_batch() for _ in range(5)]
    jh = jt.fit(batches, steps=5, log_every=1, log_fn=None)
    th = tt.fit(batches, steps=5, log_every=1, log_fn=None)
    assert [h["step"] for h in th] == [h["step"] for h in jh] == list(
        range(5))
    for a, b in zip(th, jh):
        assert set(a) == set(b)
        for k in ("loss", "ce", "z_loss", "grad_norm", "lr", "ppl"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)
    assert th[-1]["loss"] < th[0]["loss"]
