"""The port's programs (``repro_torch.launch.steps``) against the
reference's (``repro.launch.steps``), in-process on the CPU.

* Inputs and specs: for every arch at full width and every ``SHAPES``
  entry, the program's whole inputs (meta tensors) have the reference's
  shapes and dtypes (its ``eval_shape`` stand-ins), and its in/out specs
  equal the reference's shardings on a 16×16 mesh (``MeshShape`` against
  ``AbstractMesh``).
* ``Model.input_specs`` gives the reference's shapes and dtypes on the
  meta device for every arch × kind.
* Without a mesh, on the reduced f32 configs with the reference's
  parameters bridged: for every arch the prefill program's first tokens
  and the serve-step program's tokens equal the reference's programs
  jitted on a one-device mesh (a greedy row and a sampled row: the draws
  come from the same counter-based uniforms); for a dense, an MoE, an
  RWKV-6 and a Zamba2 arch the train program's loss and gradient norm
  within 1e-5 relative, and the parameters after the step within 1e-6
  absolute + 1e-5 relative of the reference's but at most a 1e-4 share
  of a leaf's elements, each within twice the step's learning rate (the
  first AdamW step moves an element by lr·g/(|g| + 1e-8), ill-conditioned
  where |g| is near 1e-8).
* The train program no longer refuses a mesh of more than one rank: at
  (2, 4) it builds with the reference's specs (``tests/test_torch_tp.py``
  runs it on 8 ranks).
"""
import importlib
import pkgutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, Mesh

from repro.config import SHAPES, ShapeConfig as JShape, get_arch as jget
from repro.core.sampling import SamplingParams as JSP
from repro.launch import steps as jsteps
from repro.models import dist as jdist
from repro.models.model import Model as JModel
from repro_torch.config import ShapeConfig, get_arch as tget
from repro_torch.core.sampling import SamplingParams as TSP
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import MeshShape
from repro_torch.models.bridge import from_jax_params
from repro_torch.models.model import Model as TModel

import repro.configs
import repro_torch.configs

for _pkg in (repro.configs, repro_torch.configs):
    for _m in pkgutil.iter_modules(_pkg.__path__):
        importlib.import_module(f"{_pkg.__name__}.{_m.name}")
from repro.config import ARCH_REGISTRY  # noqa: E402

ARCHS = sorted(ARCH_REGISTRY)


def _path(keys):
    out = ""
    for k in keys:
        if hasattr(k, "key"):
            out += f"/{k.key}"
        elif hasattr(k, "name"):
            out += f".{k.name}"
        else:
            out += f"[{k.idx}]"
    return out


def _jleaves(tree, is_leaf=None):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {_path(p): v for p, v in flat}


def _tleaves(tree, prefix="", spec=False):
    """The port's tree as {path: leaf}; with ``spec`` a plain tuple is a
    leaf (a spec), dicts and NamedTuples are nodes; None leaves dropped."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tleaves(v, f"{prefix}/{k}", spec))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for f in tree._fields:
            out.update(_tleaves(getattr(tree, f), f"{prefix}.{f}", spec))
        return out
    if isinstance(tree, list) or (isinstance(tree, tuple) and not spec):
        out = {}
        for i, v in enumerate(tree):
            out.update(_tleaves(v, f"{prefix}[{i}]", spec))
        return out
    return {} if tree is None else {prefix: tree}


def _dt(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _same_abstract(tin, jin):
    t, j = _tleaves(list(tin)), _jleaves(list(jin))
    assert sorted(t) == sorted(j)
    for k in j:
        assert tuple(t[k].shape) == tuple(j[k].shape), k
        assert _dt(t[k]) == _dt(j[k]), k
        assert t[k].device.type == "meta", k


def _same_specs(tspecs, jspecs):
    t = _tleaves(list(tspecs), spec=True)
    j = _jleaves(list(jspecs), is_leaf=lambda x: hasattr(x, "spec"))
    assert sorted(t) == sorted(j)
    for k in j:
        assert t[k] == tuple(j[k].spec), (k, t[k], j[k].spec)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_program_inputs_and_specs_match_reference(arch, shape):
    jshape = SHAPES[shape]
    tshape = ShapeConfig(**{f: getattr(jshape, f) for f in
                            ("name", "seq_len", "global_batch", "kind",
                             "window_override")})
    jm = AbstractMesh((16, 16), ("data", "model"))
    tm = MeshShape((16, 16), ("data", "model"))
    jout = jsteps.program_for(jshape.kind)(jget(arch), jshape, jm)
    kw = {} if jshape.kind == "train" else {"device": "cpu"}
    tout = tsteps.program_for(tshape.kind)(tget(arch), tshape, tm, **kw)
    _same_abstract(tout[1], jout[1])
    _same_specs(tout[2], jout[2])
    _same_specs(tout[3], jout[3])
    assert tout[4] == jout[4]


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch):
    jm, tm = JModel(jget(arch)), TModel(tget(arch))
    for kind in ("train", "prefill", "decode"):
        j, t = jm.input_specs(3, 7, kind), tm.input_specs(3, 7, kind)
        assert sorted(j) == sorted(t)
        for k in j:
            assert tuple(t[k].shape) == tuple(j[k].shape)
            assert _dt(t[k]) == _dt(j[k])
            assert t[k].device.type == "meta"


def test_train_program_refuses_a_mesh():
    # it did until the train step ran under a mesh; now it builds at (2, 4)
    # with the reference's specs
    jout = jsteps.make_train_step_program(
        jget("smollm-360m").reduced(), JShape("t", 8, 2, "train"),
        AbstractMesh((2, 4), ("data", "model")))
    tout = tsteps.make_train_step_program(
        tget("smollm-360m").reduced(), ShapeConfig("t", 8, 2, "train"),
        MeshShape((2, 4), ("data", "model")))
    _same_specs(tout[2], jout[2])
    _same_specs(tout[3], jout[3])
    assert tout[4] == jout[4] == ("data",)


# ---------------------------------------------------------------------------
# The programs without a mesh against the reference's on one device
# ---------------------------------------------------------------------------

B, S = 2, 8
# row 0 greedy, row 1 sampled (τ 0.8, top-k 20, a repetition penalty)
SP = dict(temperature=[0.0, 0.8], top_k=[0, 20], top_p=[1.0, 1.0],
          min_p=[0.0, 0.0], repetition_penalty=[1.0, 1.2],
          presence_penalty=[0.0, 0.0], frequency_penalty=[0.0, 0.0])
SP_DT = dict(top_k=np.int32)


def _one_mesh():
    return Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))


def _jit(out, mesh):
    fn, _, ins, outs, batch_axes = out
    return jax.jit(fn, in_shardings=ins, out_shardings=outs), batch_axes


def _batch(cfg, kind):
    rs = np.random.default_rng(3)
    b = {"tokens": rs.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if kind == "train":
        b["labels"] = rs.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.family == "vlm":
        b["patch_embeds"] = rs.normal(size=(
            B, cfg.frontend.num_embeddings, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        b["frames"] = rs.normal(size=(
            B, cfg.encoder.num_frames, cfg.d_model)).astype(np.float32)
    return b


def _tcache(inputs_meta_cache):
    return {k: torch.zeros(v.shape, dtype=v.dtype)
            for k, v in inputs_meta_cache.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_serve_step_match_reference(arch):
    jcfg, tcfg = jget(arch).reduced(), tget(arch).reduced()
    kw = dict(name="t", seq_len=S, global_batch=B)
    jmesh = _one_mesh()
    jp = JModel(jcfg).init(jax.random.PRNGKey(0))
    tp = from_jax_params(jp)
    batch = _batch(jcfg, "prefill")
    jsp = JSP(**{k: jnp.asarray(v, SP_DT.get(k, np.float32))
                 for k, v in SP.items()})
    tsp = TSP(**{k: torch.tensor(v, dtype=torch.int32 if k == "top_k"
                                 else torch.float32) for k, v in SP.items()})

    # prefill: the first tokens
    jout = jsteps.make_prefill_program(jcfg, JShape(kind="prefill", **kw),
                                       jmesh)
    tout = tsteps.make_prefill_program(tcfg, ShapeConfig(kind="prefill", **kw),
                                       None, device="cpu")
    jfn, baxes = _jit(jout, jmesh)
    with jdist.use_mesh(jmesh, batch_axes=baxes):
        jc0 = jax.tree_util.tree_map(lambda a: jnp.zeros(a.shape, a.dtype),
                                     jout[1][2])
        jtok, jcache = jfn(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                           jc0, jsp)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    ttok, tcache = tout[0](tp, tb, _tcache(tout[1][2]), tsp)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))

    # one serve step from the prefilled caches
    jout = jsteps.make_serve_step_program(jcfg, JShape(kind="decode", **kw),
                                          jmesh)
    tout = tsteps.make_serve_step_program(
        tcfg, ShapeConfig(kind="decode", **kw), None, device="cpu")
    jfn, baxes = _jit(jout, jmesh)
    from repro.core import penalties as jpen
    from repro_torch.core import penalties as tpen
    with jdist.use_mesh(jmesh, batch_axes=baxes):
        jst = jpen.init_state(B, jcfg.vocab_size,
                              jnp.asarray(batch["tokens"]))
        jtok2, _, _ = jfn(jp, jcache, jst, jtok, jsp, jnp.asarray(1))
    tst = tpen.init_state(B, tcfg.vocab_size, tb["tokens"])
    ttok2, _, _ = tout[0](tp, tcache, tst, ttok, tsp, 1)
    np.testing.assert_array_equal(ttok2.numpy(), np.asarray(jtok2))


@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-1b-a400m",
                                  "rwkv6-3b", "zamba2-1.2b"])
def test_train_program_matches_reference(arch):
    jcfg, tcfg = jget(arch).reduced(), tget(arch).reduced()
    kw = dict(name="t", seq_len=S, global_batch=B)
    jmesh = _one_mesh()
    jout = jsteps.make_train_step_program(jcfg, JShape(kind="train", **kw),
                                          jmesh)
    tout = tsteps.make_train_step_program(tcfg, ShapeConfig(kind="train",
                                                            **kw), None)
    jfn, _ = _jit(jout, jmesh)
    from repro.training.optimizer import adamw_init as jinit
    from repro_torch.training.optimizer import adamw_init as tinit
    jp = JModel(jcfg).init(jax.random.PRNGKey(0))
    tp = from_jax_params(jp)
    batch = _batch(jcfg, "train")
    jp2, _, jm = jfn(jp, jinit(jp), {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    tp2, _, tm = tout[0](tp, tinit(tp), {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
    for m in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[m]), float(jm[m]), rtol=1e-5)
    lr = float(jm["lr"])
    j, t = _jleaves(jp2), _tleaves(tp2)
    assert sorted(j) == sorted(t)
    for k in j:
        got, want = t[k].numpy(), np.asarray(j[k])
        off = np.abs(got - want) > 1e-6 + 1e-5 * np.abs(want)
        # AdamW's first step moves an element by lr·g/(|g| + 1e-8): where
        # |g| is near 1e-8 an ulp of the gradient moves it by up to lr
        assert off.mean() <= 1e-4, (k, int(off.sum()))
        np.testing.assert_array_less(np.abs(got - want)[off], 2 * lr,
                                     err_msg=k)
