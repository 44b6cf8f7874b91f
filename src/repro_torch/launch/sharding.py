"""Sharding rules: map every parameter / cache / batch leaf to a spec on a
mesh, and cut a rank's block out of a tensor by its spec.

A spec is a tuple with one entry a dimension: ``None`` (replicated), a
mesh axis name, or a tuple of names (the dimension split over their
flattened product, the first major) — the entries of the reference's
``PartitionSpec``. The rules read only a mesh's axis names and sizes
(:class:`~repro_torch.launch.mesh.MeshShape`, or the shape of a
``DeviceMesh``), so they hold at production sizes without the ranks.

Conventions (the reference's DESIGN.md §6):
* weights — Megatron TP on the 'model' axis (attention heads, FFN hidden,
  vocab for embeddings/LM head); MoE experts expert-parallel on 'model'
  with FSDP-style storage sharding of the expert hidden dim over the
  batch axes;
* activations/batch — (pod, data);
* KV caches — batch over (pod, data) and the cache sequence dim over
  'model';
* B = 1 — batch replicated; recurrent/KV state sharded over 'model' on a
  head/state dim instead.

Every rule degrades to replication when the dim is not divisible by the
axis size, so the same rules serve reduced configs. The port realises
only the expert blocks of a parameter tree (:func:`shard_tree` with
:func:`is_expert_leaf`): the dense stack's tensor parallelism is not
ported, and its weights stay whole on every rank.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.launch.mesh import MeshShape

Spec = Tuple


def _P(*entries) -> Spec:
    """A spec from its entries, normalised as ``PartitionSpec`` does: a
    one-axis tuple is that axis's name, an empty one None."""
    def norm(e):
        if isinstance(e, (tuple, list)):
            e = tuple(e)
            return None if not e else e[0] if len(e) == 1 else e
        return e
    return tuple(norm(e) for e in entries)


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    shape = MeshShape.of(mesh).shape
    n = 1
    for a in axes:
        n *= shape[a]
    return n


def _fit(mesh, axes, dim: int):
    """Return axes if dim divides evenly, else None (replicate)."""
    if axes is None:
        return None
    size = _axis_size(mesh, axes)
    return axes if size > 1 and dim % size == 0 else None


def _mesh_split(mesh):
    names = MeshShape.of(mesh).axis_names
    return (tuple(a for a in names if a in ("pod", "data")),
            tuple(a for a in names if a == "model"))


def batch_axes_for(shape: ShapeConfig, mesh) -> Optional[Tuple[str, ...]]:
    """Which mesh axes shard the activation batch for this input shape."""
    batch, _ = _mesh_split(mesh)
    n = _axis_size(mesh, batch)
    if shape.global_batch % max(n, 1) == 0 and shape.global_batch >= n:
        return batch
    return None          # e.g. global_batch = 1: the batch is replicated


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def param_spec(path: str, shape: Tuple[int, ...], mesh,
               cfg: ModelConfig) -> Spec:
    """Spec of one parameter leaf, keyed by its tree path
    (``/stack/attn/w_q``)."""
    batch, model = _mesh_split(mesh)
    m = model[0] if model else None
    # FSDP storage sharding uses ALL batch axes (pod + data)
    d_axes = tuple(batch) if batch else None
    nd = len(shape)

    def last(axis):   # shard the last dim
        return _P(*([None] * (nd - 1) + [_fit(mesh, axis, shape[-1])]))

    def at(i, axis):  # shard dim i
        e = [None] * nd
        e[i] = _fit(mesh, axis, shape[i])
        return _P(*e)

    p = path
    if p.endswith("emb/tok"):
        return at(0, m)                        # vocab-sharded
    if p.endswith("emb/head"):
        return last(m)
    if p.endswith("dec_pos"):
        return (None,) * nd
    # attention projections (stacked: (L, d, h) / unstacked: (d, h))
    if any(p.endswith(f"attn/{w}") or p.endswith(f"cross/{w}")
           or p.endswith(f"shared_attn/{w}") for w in ("w_q", "w_k", "w_v")):
        return last(m)
    if p.endswith("attn/w_o") or p.endswith("cross/w_o") \
            or p.endswith("shared_attn/w_o"):
        return at(nd - 2, m)
    # dense MLPs (incl. the shared expert and whisper's encoder)
    if p.endswith("w_gate") or p.endswith("w_up") or p.endswith("w_ck"):
        if "moe/" in p and "shared" not in p:
            # experts (L, E, d, f): EP on model over E, FSDP over f
            e = [None] * nd
            e[nd - 3] = _fit(mesh, m, shape[nd - 3])
            e[nd - 1] = _fit(mesh, d_axes, shape[nd - 1])
            return _P(*e)
        return last(m)
    if p.endswith("w_down") or p.endswith("w_cv"):
        if "moe/" in p and "shared" not in p:
            e = [None] * nd
            e[nd - 3] = _fit(mesh, m, shape[nd - 3])
            e[nd - 2] = _fit(mesh, d_axes, shape[nd - 2])
            return _P(*e)
        return at(nd - 2, m)
    # rwkv time-mix projections (L, d, d): shard output heads
    if any(p.endswith(f"layers/{w}") for w in ("w_r", "w_k", "w_v", "w_g")):
        return last(m)
    if p.endswith("layers/w_o") or p.endswith("layers/w_cr"):
        return at(nd - 2, m)
    # mamba / routers / norms / vectors / loras: replicated
    return (None,) * nd


def is_expert_leaf(path: str) -> bool:
    """A routed expert's weight (``.../moe/w_gate|w_up|w_down``): the
    leaves this port shards (E over model, f over the batch axes)."""
    return "moe/" in path and "shared" not in path and \
        path.rsplit("/", 1)[-1] in ("w_gate", "w_up", "w_down")


def _walk(tree, prefix, fn):
    if isinstance(tree, dict):
        return {k: _walk(v, f"{prefix}/{k}", fn) for k, v in tree.items()}
    return fn(prefix, tree)


def param_shardings(params, mesh, cfg: ModelConfig):
    """Tree of specs matching the parameter tree (leaves: anything with a
    ``shape``)."""
    return _walk(params, "",
                 lambda p, leaf: param_spec(p, tuple(leaf.shape), mesh, cfg))


def opt_shardings(opt, param_spec_tree, mesh):
    """AdamW moments mirror the parameter specs; the step is replicated
    (an ``AdamWState`` of specs)."""
    from repro_torch.training.optimizer import AdamWState
    return AdamWState(step=(), mu=param_spec_tree, nu=param_spec_tree)


# ---------------------------------------------------------------------------
# Batch / cache / decision-plane state
# ---------------------------------------------------------------------------


def _tree_map(fn, tree, path=()):
    """Map ``fn(path, leaf)`` over dicts, lists, tuples and NamedTuples;
    the path's keys are dict keys, ``.name`` for a NamedTuple field and
    ``[i]`` for a list or tuple index (the reference's key strings)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, getattr(tree, f), path + (f".{f}",))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, path + (f"[{i}]",))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def batch_shardings(batch, mesh, batch_axes):
    b = tuple(batch_axes) if batch_axes else None

    def f(_, leaf):
        e = [b] + [None] * (len(leaf.shape) - 1)
        if b is None or leaf.shape[0] % _axis_size(mesh, b) != 0:
            e[0] = None
        return _P(*e)

    return _tree_map(f, batch)


def cache_shardings(cache, mesh, cfg: ModelConfig, batch_axes):
    """KV cache (L|G, B, Sc, kv, hd): batch over batch_axes, Sc over
    model. SSM states: batch over batch_axes; with B replicated, shard a
    head/state dim over model instead."""
    batch, model = _mesh_split(mesh)
    m = model[0] if model else None
    b = tuple(batch_axes) if batch_axes else None

    def f(path, leaf):
        name = "/".join(path)
        shape = tuple(leaf.shape)
        nd = len(shape)
        if nd <= 1:
            return ()
        e = [None] * nd
        if b is not None and shape[1] % _axis_size(mesh, b) == 0:
            e[1] = b
        if name.endswith("k") or name.endswith("v"):
            e[2] = _fit(mesh, m, shape[2])
        elif name == "ssm":
            if e[1] is None:
                if shape[2] % _axis_size(mesh, (m,) if m else None) == 0:
                    e[2] = _fit(mesh, m, shape[2])
                else:
                    e[4] = _fit(mesh, m, shape[4])
        elif name in ("x_last_t", "x_last_c"):
            e[2] = _fit(mesh, m, shape[2])
        elif name == "conv":
            e[3] = _fit(mesh, m, shape[3])
        return _P(*e)

    return _tree_map(f, cache)


def decision_state_shardings(state, mesh, batch_axes,
                             mode: str = "sequence_parallel"):
    """Penalty histograms (B, V):

    * sequence_parallel — batch over ALL axes (every rank a sampler);
    * hierarchical      — batch over batch axes, V over model (the state
      lives with the logits blocks; Eq. 5 updates are block-local);
    * vocab_gather      — batch over batch axes only (baseline).
    """
    batch, model = _mesh_split(mesh)
    m = model[0] if model else None
    if mode == "sequence_parallel":
        axes = (tuple(batch_axes) if batch_axes else ()) + model
    else:
        axes = tuple(batch_axes) if batch_axes else ()
    axes = axes or None

    def f(_, leaf):
        shape = tuple(leaf.shape)
        if len(shape) == 0:
            return ()
        e = [None] * len(shape)
        if axes is not None and shape[0] % _axis_size(mesh, axes) == 0:
            e[0] = axes
        if mode == "hierarchical" and len(shape) >= 2:
            e[-1] = _fit(mesh, m, shape[-1])
        return _P(*e)

    return _tree_map(f, state)


def replicated(mesh, tree):
    """A spec of all-None entries for every leaf."""
    return _tree_map(lambda _, leaf: (None,) * len(leaf.shape), tree)


# ---------------------------------------------------------------------------
# Realising a spec: a rank's block
# ---------------------------------------------------------------------------


def _coords_of(mesh, coords):
    if coords is not None:
        return dict(coords)
    names = mesh.mesh_dim_names
    return dict(zip(names, mesh.get_coordinate()))


def local_shard(tensor: torch.Tensor, spec: Spec, mesh, coords=None):
    """The block of ``tensor`` that the rank at ``coords`` (a dict axis ->
    index; default this rank's coordinate on the ``DeviceMesh``) holds
    under ``spec``: each sharded dimension cut to its even block, the
    block's index linear over the entry's axes, the first major."""
    shape = MeshShape.of(mesh).shape
    where = _coords_of(mesh, coords)
    out = tensor
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        n, r = 1, 0
        for a in axes:
            n *= shape[a]
            r = r * shape[a] + where[a]
        size = tensor.shape[dim]
        if size % n:
            raise ValueError(f"dim {dim} of {tuple(tensor.shape)} does not "
                             f"split over {axes}")
        c = size // n
        out = out.narrow(dim, r * c, c)
    return out


def shard_tree(params, mesh, cfg: ModelConfig, coords=None,
               keep: Callable[[str], bool] = is_expert_leaf):
    """The rank's blocks of a parameter tree: leaves whose path passes
    ``keep`` are cut by :func:`param_spec` (contiguous copies, so the
    full tensors can be dropped), the others stay whole."""
    def f(path, leaf):
        if not keep(path):
            return leaf
        spec = param_spec(path, tuple(leaf.shape), mesh, cfg)
        return local_shard(leaf, spec, mesh, coords).contiguous()

    return _walk(params, "", f)
