"""The port's sharding rules and meshes against the reference's, and the
distribution seams without a mesh, in-process on the CPU.

* ``param_spec`` of every leaf of every registered arch at full width
  (the reference's ``eval_shape`` tree: no weights are made) equals the
  reference's, on a ``MeshShape`` against an ``AbstractMesh`` of 16×16
  and 2×16×16; ``cache_shardings``, ``decision_state_shardings``,
  ``batch_shardings`` and ``batch_axes_for`` likewise on the reduced
  archs and the reference's shapes;
* ``local_shard`` / ``shard_tree`` cut blocks that tile the tensor back;
* ``make_production_mesh`` raises below 256 ranks;
* every ``sampling_parallelism`` without a mesh is the identity, in the
  ``DecisionPlane`` and in an ``Engine``.
"""
import importlib
import pkgutil

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import repro.configs
import repro_torch.configs
from repro.config import SHAPES, get_arch as jget
from repro.core.penalties import PenaltyState as JPenaltyState
from repro.launch import sharding as jsh
from repro.models.model import Model as JModel
from repro_torch.config import SamplingConfig, ShapeConfig, get_arch as tget
from repro_torch.core import penalties as tpen
from repro_torch.core.decision_plane import MODES, DecisionPlane
from repro_torch.core.sampling import SamplingParams
from repro_torch.engine.engine import Engine, EngineConfig
from repro_torch.engine.request import Request
from repro_torch.launch import mesh as tmesh, sharding as tsh
from repro_torch.models import dist
from repro_torch.models.model import Model as TModel

for _pkg in (repro.configs, repro_torch.configs):
    for _m in pkgutil.iter_modules(_pkg.__path__):
        importlib.import_module(f"{_pkg.__name__}.{_m.name}")
from repro.config import ARCH_REGISTRY  # noqa: E402

ARCHS = sorted(ARCH_REGISTRY)
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(name):
    sizes, names = MESHES[name]
    return AbstractMesh(sizes, names), tmesh.MeshShape(sizes, names)


def _spec(p):
    """A reference PartitionSpec (or NamedSharding) as the port's tuple."""
    p = getattr(p, "spec", p)
    return tuple(p)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tuple(tree.shape)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, mesh):
    jcfg, tcfg = jget(arch), tget(arch)
    jm, tm = _meshes(mesh)
    tree = jax.eval_shape(JModel(jcfg).init, jax.random.PRNGKey(0))
    n = 0
    for path, shape in _leaves(tree):
        want = _spec(jsh.param_spec(path, shape, jm, jcfg))
        assert tsh.param_spec(path, shape, tm, tcfg) == want, (path, shape)
        n += 1
    assert n > 5


def _abstract_cache(cfg, B):
    return jax.eval_shape(lambda: JModel(cfg).init_cache(B, 64))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_specs_match_reference(arch, mesh):
    jcfg, tcfg = jget(arch).reduced(), tget(arch).reduced()
    jm, tm = _meshes(mesh)
    for B in (32, 1):
        jcache = _abstract_cache(jcfg, B)
        tcache = TModel(tcfg).init_cache(B, 64, device="cpu")
        assert set(jcache) == set(tcache)
        for shape in SHAPES.values():
            tshape = ShapeConfig(shape.name, shape.seq_len, B, shape.kind)
            jb = jsh.batch_axes_for(
                type(shape)(shape.name, shape.seq_len, B, shape.kind), jm)
            assert tsh.batch_axes_for(tshape, tm) == jb
        b_axes = tsh.batch_axes_for(ShapeConfig("d", 64, B, "decode"), tm)
        want = jsh.cache_shardings(jcache, jm, jcfg, b_axes)
        got = tsh.cache_shardings(tcache, tm, tcfg, b_axes)
        for k in jcache:
            assert got[k] == _spec(want[k]), (k, jcache[k].shape)
        batch = {"tokens": np.zeros((B, 8), np.int32),
                 "lens": np.zeros((B,), np.int32)}
        want = jsh.batch_shardings(jax.tree_util.tree_map(
            lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), batch), jm,
            b_axes)
        got = tsh.batch_shardings(batch, tm, b_axes)
        assert {k: got[k] for k in batch} == \
            {k: _spec(want[k]) for k in batch}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_decision_state_specs_match_reference(mesh, mode):
    jm, tm = _meshes(mesh)
    for B, V in ((512, 49152), (16, 49155), (1, 256)):
        leaf = jax.ShapeDtypeStruct((B, V), np.int32)
        jstate = JPenaltyState(leaf, leaf)
        tstate = tpen.PenaltyState(torch.empty((B, V), dtype=torch.int32),
                                   torch.empty((B, V), dtype=torch.int32))
        for b_axes in (("data",), tm.axis_names[:-1], None):
            want = jsh.decision_state_shardings(jstate, jm, b_axes, mode)
            got = tsh.decision_state_shardings(tstate, tm, b_axes, mode)
            assert tuple(got) == tuple(_spec(w) for w in want), (B, V, b_axes)


def test_param_shardings_tree_and_local_shards_tile():
    """A reduced granite tree: ``param_shardings`` mirrors the reference's
    tree; ``shard_tree``'s expert blocks over every coordinate of a
    (2, 4) mesh tile each expert tensor exactly; other leaves stay
    whole."""
    cfg = tget("granite-moe-1b-a400m").reduced()
    params = TModel(cfg).init(seed=0, device="cpu")
    jm, tm = AbstractMesh((2, 4), ("data", "model")), \
        tmesh.MeshShape((2, 4), ("data", "model"))
    jcfg = jget("granite-moe-1b-a400m").reduced()
    jtree = jax.eval_shape(JModel(jcfg).init, jax.random.PRNGKey(0))
    specs = tsh.param_shardings(params, tm, cfg)
    jspecs = jsh.param_shardings(jtree, jm, jcfg)

    def pairs(t, j, prefix=""):
        if isinstance(t, dict):
            for k in t:
                yield from pairs(t[k], j[k], f"{prefix}/{k}")
        else:
            yield prefix, t, _spec(j)

    n = 0
    for path, got, exp in pairs(specs, jspecs):
        assert got == exp, path
        n += 1
    assert n > 5
    opt = tsh.opt_shardings(None, specs, tm)
    assert opt.step == () and opt.mu is specs and opt.nu is specs
    rep = tsh.replicated(tm, params)
    assert rep["stack"]["moe"]["w_gate"] == (None,) * 4
    w = params["stack"]["moe"]["w_gate"]                 # (L, E, d, f)
    blocks = {}
    for d in range(2):
        for m in range(4):
            t = tsh.shard_tree(params, tm, cfg, coords={"data": d,
                                                        "model": m})
            assert t["stack"]["attn"]["w_q"] is params["stack"]["attn"]["w_q"]
            blocks[d, m] = t["stack"]["moe"]["w_gate"]
            assert blocks[d, m].shape == (w.shape[0], w.shape[1] // 4,
                                          w.shape[2], w.shape[3] // 2)
    rebuilt = torch.cat([torch.cat([blocks[d, m] for d in range(2)], dim=3)
                         for m in range(4)], dim=1)
    assert torch.equal(rebuilt, w)


def test_production_mesh_needs_its_ranks():
    assert tmesh.production_shape().shape == {"data": 16, "model": 16}
    assert tmesh.production_shape(multi_pod=True).size == 512
    for multi in (False, True):
        with pytest.raises(RuntimeError, match="ranks"):
            tmesh.make_production_mesh(multi_pod=multi)
    assert tmesh.mesh_axes(tmesh.production_shape(multi_pod=True)) == \
        (("pod", "data"), ("model",))


def _params(B, rs):
    return SamplingParams(
        temperature=torch.tensor(rs.choice([0.0, 0.7, 1.0], B),
                                 dtype=torch.float32),
        top_k=torch.tensor(rs.choice([0, 20], B), dtype=torch.int32),
        top_p=torch.tensor(rs.choice([1.0, 0.9], B), dtype=torch.float32),
        min_p=torch.zeros(B), repetition_penalty=torch.full((B,), 1.2),
        presence_penalty=torch.full((B,), 0.1),
        frequency_penalty=torch.zeros(B))


@pytest.mark.parametrize("algorithm", ["shvs", "fused", "gumbel"])
def test_modes_without_mesh_are_identity_in_plane(algorithm):
    assert not dist.get_ctx().active
    B, V = 8, 512
    rs = np.random.default_rng(2)
    z = torch.from_numpy(rs.normal(0, 2, (B, V)).astype(np.float32))
    prompts = torch.from_numpy(rs.integers(0, V, (B, 6)))
    p = _params(B, rs)
    runs = {}
    for mode in MODES:
        plane = DecisionPlane(V, algorithm=algorithm, sampling_parallelism=mode,
                              k_cap=64, seed=3, device="cpu")
        st = plane.init_state(B, prompt_tokens=prompts)
        toks = []
        for s in range(3):
            t, st, _ = plane.step(z, st, p, s)
            toks.append(t)
        runs[mode] = (torch.stack(toks), st.output_counts)
    for mode in MODES[1:]:
        assert torch.equal(runs[mode][0], runs[MODES[0]][0])
        assert torch.equal(runs[mode][1], runs[MODES[0]][1])
    with pytest.raises(ValueError, match="sampling parallelism"):
        DecisionPlane(V, sampling_parallelism="pipeline", device="cpu")


def test_modes_without_mesh_are_identity_in_engine():
    cfg = tget("smollm-360m").reduced()
    params = TModel(cfg).init(seed=0, device="cpu")
    rs = np.random.default_rng(4)
    prompts = [rs.integers(0, cfg.vocab_size, n).tolist() for n in (5, 9, 3)]
    streams = {}
    for mode in MODES:
        eng = Engine(cfg, params, EngineConfig(
            max_batch=4, max_seq_len=64, k_cap=64,
            sampling_parallelism=mode), device="cpu")
        assert eng.decision.parallelism == mode
        reqs = [Request(request_id=i, prompt=pr, max_new_tokens=6,
                        sampling=SamplingConfig(temperature=0.8,
                                                repetition_penalty=1.1))
                for i, pr in enumerate(prompts)]
        eng.submit(reqs)
        eng.run()
        streams[mode] = [list(r.output) for r in reqs]
    for mode in MODES[1:]:
        assert streams[mode] == streams[MODES[0]]


def test_gumbel_plain_version_keys_the_batch_row():
    """``row0``: rows row0.. of a batch draw those rows' noise, so a rank
    deciding a block of rows gets the whole batch's tokens there."""
    from repro_torch.kernels import ref
    rs = np.random.default_rng(8)
    z = torch.from_numpy(rs.normal(0, 2, (8, 300)).astype(np.float32))
    whole = ref.gumbel_argmax_ref(z, 77)
    for row0 in (1, 2, 6):
        assert torch.equal(ref.gumbel_argmax_ref(z[row0:row0 + 2], 77, row0),
                           whole[row0:row0 + 2])
