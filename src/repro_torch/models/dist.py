"""Distribution context and the collectives of the port's SPMD code.

The reference writes its distributed code as ``shard_map`` bodies over
global arrays. Here every rank runs the body itself: it holds only its own
block, as a plain tensor on its device, and each ``lax`` collective of the
reference is one wrapper below over the process group of the named mesh
axes (a ``torch.distributed.DeviceMesh``):

    all_gather(x, axes, dim, tiled)     lax.all_gather
    psum / pmax / pmean(x, axes)        lax.psum / pmax / pmean
    psum_scatter(x, axes, dim)          lax.psum_scatter(tiled=True)
    all_to_all(x, axes, split, concat)  lax.all_to_all(tiled=True)
    axis_index(axes)                    the linear lax.axis_index

A group over several axes, such as ``("pod", "data")``, is the flattened
group of those mesh dimensions, ranked in mesh order (the order the
reference's collectives and its linear axis index use). Without a mesh,
every wrapper is the identity (a group of one).

The launcher installs the mesh and the logical axis assignment with
:func:`set_mesh` / :func:`use_mesh`; model code reads it with
:func:`get_ctx`, as in the reference.

Transport. Under NCCL every collective runs on the card. Ranks that share
one card cannot use NCCL (it takes one rank a device), so they run over
gloo, which refuses CUDA tensors for some collectives: such a collective
is staged through pinned host memory here, explicitly and in this one
place, and named by :func:`staged_collectives`. Every op of the
computation still runs on the card; only the bytes between ranks cross
the host.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as tdist


@dataclass
class DistContext:
    mesh: Optional[object] = None                     # a DeviceMesh
    # logical axis name -> mesh axis name(s)
    batch_axes: Optional[Sequence[str]] = ("data",)   # batch dim of activations
    model_axes: Optional[Sequence[str]] = ("model",)  # tensor-parallel dim
    # None batch_axes => batch replicated

    @property
    def active(self) -> bool:
        return self.mesh is not None

    def axis_size(self, axes) -> int:
        if not self.active or not axes:
            return 1
        names = self.mesh.mesh_dim_names
        n = 1
        for a in _axes(axes):
            n *= self.mesh.mesh.shape[names.index(a)]
        return n


_CTX = DistContext()


def get_ctx() -> DistContext:
    return _CTX


def set_mesh(mesh, batch_axes=("data",), model_axes=("model",)) -> None:
    global _CTX
    _CTX = DistContext(mesh=mesh,
                       batch_axes=tuple(batch_axes) if batch_axes else None,
                       model_axes=tuple(model_axes) if model_axes else None)


@contextlib.contextmanager
def use_mesh(mesh, batch_axes=("data",), model_axes=("model",)):
    global _CTX
    prev = _CTX
    set_mesh(mesh, batch_axes, model_axes)
    try:
        yield _CTX
    finally:
        _CTX = prev


def constrain(x: torch.Tensor, *spec) -> torch.Tensor:
    """The identity. The reference's ``with_sharding_constraint`` tells
    GSPMD how a global array is laid out; here a rank already holds its
    own block, so there is nothing to re-lay (the port's re-shards are
    explicit collectives, as in ``core/sequence_parallel.py``)."""
    return x


def batch_spec_entry():
    """Spec entry for the activation batch dimension."""
    ctx = get_ctx()
    if not ctx.active or ctx.batch_axes is None:
        return None
    return tuple(ctx.batch_axes) if len(ctx.batch_axes) > 1 \
        else ctx.batch_axes[0]


def model_spec_entry():
    ctx = get_ctx()
    if not ctx.active or ctx.model_axes is None:
        return None
    return tuple(ctx.model_axes) if len(ctx.model_axes) > 1 \
        else ctx.model_axes[0]


# ---------------------------------------------------------------------------
# Groups and indices
# ---------------------------------------------------------------------------


def _axes(axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


_GROUPS: Dict[tuple, object] = {}


def _group(axes):
    """The process group of this rank over ``axes`` of the context's mesh
    (None without a mesh or axes). Several axes: every rank creates every
    group of the partition, in one order, and keeps its own."""
    ctx = get_ctx()
    axes = _axes(axes)
    if not ctx.active or not axes:
        return None
    mesh = ctx.mesh
    names = list(mesh.mesh_dim_names)
    dims = [names.index(a) for a in axes]
    if dims != sorted(dims):
        raise ValueError(f"axes {axes} must come in mesh order {names}")
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    key = (mesh, axes)        # holds the mesh: no other can take its place
    if key not in _GROUPS:
        others = [i for i in range(len(names)) if i not in dims]
        n = 1
        for i in dims:
            n *= mesh.mesh.shape[i]
        rows = mesh.mesh.permute(*others, *dims).reshape(-1, n)
        me = tdist.get_rank()
        mine = None
        for row in rows.tolist():
            g = tdist.new_group(ranks=row)
            if me in row:
                mine = g
        _GROUPS[key] = mine
    return _GROUPS[key]


def axis_index(axes) -> int:
    """This rank's linear index over ``axes`` (the first axis major), as
    the reference's ``r = r * size + lax.axis_index(ax)`` loops compute
    it; 0 without a mesh."""
    ctx = get_ctx()
    if not ctx.active:
        return 0
    names = list(ctx.mesh.mesh_dim_names)
    coord = ctx.mesh.get_coordinate()
    r = 0
    for a in _axes(axes):
        i = names.index(a)
        r = r * ctx.mesh.mesh.shape[i] + coord[i]
    return r


def rows(B: int, axes) -> Tuple[int, int]:
    """(start, count) of the rows of a global batch of B that this rank
    holds when the batch is split over ``axes``: an even block where the
    axes' size divides B, all B rows (replicated) otherwise — the
    reference's rule for a sharded dimension (``sharding._fit``)."""
    n = get_ctx().axis_size(axes)
    if n > 1 and B % n == 0:
        c = B // n
        return axis_index(axes) * c, c
    return 0, B


# ---------------------------------------------------------------------------
# Transport: gloo's refusals staged through the host; optional timing
# ---------------------------------------------------------------------------

#: collectives that gloo refused for CUDA tensors: staged through pinned
#: host memory from then on
_STAGED: set = set()
#: per collective: [calls, seconds, bytes of the rank's input]
_STATS: Dict[str, list] = {}
_TIMED = False


#: one block a rank into a flat buffer (newer torch renames the call)
_gather_single = getattr(tdist, "all_gather_single", None) or \
    tdist.all_gather_into_tensor


def staged_collectives() -> Tuple[str, ...]:
    """The collectives staged through host memory so far (gloo + CUDA)."""
    return tuple(sorted(_STAGED))


def set_timing(on: bool) -> None:
    """Time each collective on the host's clock, the device synchronised
    before and after (off by default: it serialises the stream)."""
    global _TIMED
    _TIMED = bool(on)


def collective_stats() -> Dict[str, dict]:
    """Per collective since the last reset: calls, the rank's input bytes
    and, with :func:`set_timing`, wall seconds."""
    return {k: {"calls": c, "seconds": s, "bytes": b}
            for k, (c, s, b) in _STATS.items()}


def reset_collective_stats() -> None:
    _STATS.clear()


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _transport(name: str, fn, out: torch.Tensor, inp: torch.Tensor, group):
    """Run ``fn(out, inp, group)``; under gloo, a CUDA tensor goes through
    pinned host buffers where gloo refuses it."""
    t0 = None
    if _TIMED:
        _sync(inp)
        t0 = time.perf_counter()
    if inp.is_cuda and tdist.get_backend(group) == "gloo":
        if name not in _STAGED:
            try:
                fn(out, inp, group)
            except RuntimeError:
                # gloo checks the device before it exchanges anything, so
                # every rank refuses the same call
                _STAGED.add(name)
        if name in _STAGED:
            h_in = torch.empty(inp.shape, dtype=inp.dtype, pin_memory=True)
            h_in.copy_(inp)
            h_out = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            fn(h_out, h_in, group)
            out.copy_(h_out)
    else:
        fn(out, inp, group)
    st = _STATS.setdefault(name, [0, 0.0, 0])
    st[0] += 1
    st[2] += inp.numel() * inp.element_size()
    if t0 is not None:
        _sync(out)
        st[1] += time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# The collectives
# ---------------------------------------------------------------------------


def all_gather(x: torch.Tensor, axes, dim: int = 0, tiled: bool = False):
    """``lax.all_gather``: the blocks of the group stacked on a new axis
    ``dim`` (``tiled``: concatenated along ``dim``), in group order."""
    g = _group(axes)
    if g is None:
        return x if tiled else x.unsqueeze(dim)
    n = tdist.get_world_size(g)
    flat = x.contiguous().reshape(-1)
    out = flat.new_empty((n * flat.numel(),))
    _transport("all_gather",
               lambda o, i, gr: _gather_single(o, i, group=gr), out, flat, g)
    out = out.view((n,) + tuple(x.shape)).movedim(0, dim)
    if not tiled:
        return out
    shape = list(x.shape)
    shape[dim] *= n
    return out.reshape(shape)


def _all_reduce(name: str, op, x: torch.Tensor, axes):
    g = _group(axes)
    if g is None:
        return x
    out = x.contiguous().clone()

    def fn(o, i, gr):
        if o is not i:
            o.copy_(i)
        tdist.all_reduce(o, op=op, group=gr)

    return _transport(name, fn, out, out, g)


def psum(x: torch.Tensor, axes):
    return _all_reduce("psum", tdist.ReduceOp.SUM, x, axes)


def pmax(x: torch.Tensor, axes):
    return _all_reduce("pmax", tdist.ReduceOp.MAX, x, axes)


def pmean(x: torch.Tensor, axes):
    return psum(x, axes) / get_ctx().axis_size(_axes(axes))


def psum_scatter(x: torch.Tensor, axes, dim: int = 0):
    """``lax.psum_scatter(tiled=True)``: the group's sum, of which this
    rank keeps block ``axis_index(axes)`` along ``dim``."""
    g = _group(axes)
    if g is None:
        return x
    n = tdist.get_world_size(g)
    xs = x.movedim(dim, 0).contiguous()
    out = xs.new_empty((xs.shape[0] // n,) + tuple(xs.shape[1:]))
    _transport("psum_scatter",
               lambda o, i, gr: tdist.reduce_scatter_tensor(
                   o, i, op=tdist.ReduceOp.SUM, group=gr),
               out, xs, g)
    return out.movedim(0, dim)


def all_to_all(x: torch.Tensor, axes, split_dim: int, concat_dim: int):
    """``lax.all_to_all(tiled=True)``: ``x`` split into n blocks along
    ``split_dim``, block j sent to group rank j, and the n blocks received
    concatenated along ``concat_dim`` in group order."""
    g = _group(axes)
    if g is None:
        return x
    n = tdist.get_world_size(g)
    xs = x.movedim(split_dim, 0).contiguous()
    out = torch.empty_like(xs)
    _transport("all_to_all",
               lambda o, i, gr: tdist.all_to_all_single(o, i, group=gr),
               out, xs, g)
    # out: the block from rank i on rows i*c..(i+1)*c, in xs's layout
    c = xs.shape[0] // n
    z = out.reshape((n, c) + tuple(xs.shape[1:])).movedim(1, 0)  # (c, n, ..)
    order = []
    for d in range(x.dim()):
        if d == split_dim:
            order.append(0)
            continue
        axis = 2 + (d if d < split_dim else d - 1)
        order += [1, axis] if d == concat_dim else [axis]
    shape = list(x.shape)
    shape[split_dim] = c
    shape[concat_dim] *= n
    return z.permute(*order).reshape(shape)
