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

Tensor parallelism. Under a mesh whose model axes have size t > 1 a rank
holds the blocks ``launch/sharding.param_spec`` gives it, and the forward
reads from each leaf's own shape whether it is split: a leaf whose
dimension is t times smaller than the config's is the rank's block
(:func:`split_block`), an equal one is whole (``_fit`` kept it so, where t
does not divide the dimension). :func:`tp_size`, :func:`tp_rank`,
:func:`gather_model`, :func:`gather_cols` and :func:`psum_model` are the
model-axes collectives of the Megatron forward (``models/layers.py``,
``models/attention.py``); each counts in :func:`collective_stats` as the
wrapper it calls.

Gradients. Every collective is differentiable, its backward the
adjoint of the multi-rank linear map it computes (JAX's transpose rules):
a ``psum``'s is a ``psum``, an all-gather's a reduce-scatter and a
reduce-scatter's an all-gather, an all-to-all's the inverse all-to-all;
``pmax`` takes no gradient. So a rank's cotangent of a tensor every rank
of a group holds (a replicated activation) is its share of the whole
cotangent, and the shares sum to it at the next collective: no call site
has to pick between a slice and a reduce-scatter, and a leaf the ranks
hold whole ends with its share, which ``training/train_loop.grads_of``
sums over the axes that hold it. Collectives run by a backward count in
:func:`collective_stats` as the forward's do; :func:`phase_stats` splits
them into the forward, the backward, remat's re-run of a layer's forward
inside the backward, and any phase a caller names (:func:`phase`).

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
from torch.utils._python_dispatch import _disable_current_modes


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
        # the mesh's ranks read with no dispatch mode on (a trace on fake
        # tensors must not take them for its own)
        with _disable_current_modes():
            rows = mesh.mesh.permute(*others, *dims).reshape(-1, n).tolist()
        me = tdist.get_rank()
        mine = None
        for row in rows:
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
#: per collective: [calls, seconds, bytes of the rank's input, bytes it
#: receives under ``launch/hlo_analysis``'s conventions]
_STATS: Dict[str, list] = {}
#: the same, per (phase, collective)
_PHASE_STATS: Dict[Tuple[str, str], list] = {}
_PHASE: Optional[str] = None
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
    """Per collective since the last reset: calls, the rank's input bytes,
    the bytes it received (all-gather (n − 1)·in, all-reduce 2·in,
    reduce-scatter in − in/n, all-to-all in; n the group's size) and,
    with :func:`set_timing`, wall seconds."""
    return {k: {"calls": c, "seconds": s, "bytes": b, "received": r}
            for k, (c, s, b, r) in _STATS.items()}


def phase_stats() -> Dict[str, Dict[str, dict]]:
    """:func:`collective_stats` split by phase: "forward", "backward"
    (a collective's adjoint), "remat" (a checkpointed layer's forward
    run again inside the backward) or a name given by :func:`phase`."""
    out: Dict[str, Dict[str, dict]] = {}
    for (ph, k), (c, s, b, r) in _PHASE_STATS.items():
        out.setdefault(ph, {})[k] = {"calls": c, "seconds": s, "bytes": b,
                                     "received": r}
    return out


def reset_collective_stats() -> None:
    _STATS.clear()
    _PHASE_STATS.clear()


@contextlib.contextmanager
def phase(name: str):
    """Count the collectives run inside under ``name`` in
    :func:`phase_stats` (the train step's gradient mean and norm)."""
    global _PHASE
    prev, _PHASE = _PHASE, name
    try:
        yield
    finally:
        _PHASE = prev


def _current_phase() -> str:
    if _PHASE is not None:
        return _PHASE
    if torch._C._current_autograd_node() is None:
        return "forward"
    return "backward" if _IN_ADJOINT else "remat"


def received_bytes(name: str, nbytes: int, n: int) -> int:
    """The bytes a rank receives from collective ``name`` over a group of
    ``n`` given an input of ``nbytes`` (``launch/hlo_analysis``'s
    conventions, the reference's)."""
    if name == "all_gather":
        return (n - 1) * nbytes
    if name in ("psum", "pmax"):
        return 2 * nbytes
    if name == "psum_scatter":
        return nbytes - nbytes // max(n, 1)
    return nbytes


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
    nbytes = inp.numel() * inp.element_size()
    got = received_bytes(name, nbytes, tdist.get_world_size(group))
    dt = 0.0
    if t0 is not None:
        _sync(out)
        dt = time.perf_counter() - t0
    for st in (_STATS.setdefault(name, [0, 0.0, 0, 0]),
               _PHASE_STATS.setdefault((_current_phase(), name),
                                       [0, 0.0, 0, 0])):
        st[0] += 1
        st[1] += dt
        st[2] += nbytes
        st[3] += got
    return out


# ---------------------------------------------------------------------------
# The collectives
# ---------------------------------------------------------------------------


def _all_gather(x: torch.Tensor, axes, dim: int = 0, tiled: bool = False):
    dim %= x.dim() + (0 if tiled else 1)
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


def _psum_scatter(x: torch.Tensor, axes, dim: int = 0):
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


def _all_to_all(x: torch.Tensor, axes, split_dim: int, concat_dim: int):
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



# Each collective with its adjoint as the backward. A Function is built
# only where a gradient can flow: serving runs the plain calls.
_IN_ADJOINT = False


def _adjoint(fn, *args):
    global _IN_ADJOINT
    prev, _IN_ADJOINT = _IN_ADJOINT, True
    try:
        return fn(*args)
    finally:
        _IN_ADJOINT = prev


def _grad_flows(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _AllGatherFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, dim, tiled):
        ctx.args = (axes, dim, tiled)
        return _all_gather(x, axes, dim, tiled)

    @staticmethod
    def backward(ctx, g):
        axes, dim, tiled = ctx.args
        if not tiled:          # the stacked axis: scatter over it
            return (_adjoint(_psum_scatter, g, axes, dim).squeeze(dim),
                    None, None, None)
        return _adjoint(_psum_scatter, g, axes, dim), None, None, None


class _PsumFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes = axes
        return _all_reduce("psum", tdist.ReduceOp.SUM, x, axes)

    @staticmethod
    def backward(ctx, g):
        return _adjoint(_all_reduce, "psum", tdist.ReduceOp.SUM, g,
                        ctx.axes), None


class _PsumScatterFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, dim):
        ctx.args = (axes, dim)
        return _psum_scatter(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        axes, dim = ctx.args
        return _adjoint(_all_gather, g, axes, dim, True), None, None


class _AllToAllFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, split_dim, concat_dim):
        ctx.args = (axes, split_dim, concat_dim)
        return _all_to_all(x, axes, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        axes, split_dim, concat_dim = ctx.args
        return (_adjoint(_all_to_all, g, axes, concat_dim, split_dim),
                None, None, None)


def all_gather(x: torch.Tensor, axes, dim: int = 0, tiled: bool = False):
    """``lax.all_gather``: the blocks of the group stacked on a new axis
    ``dim`` (``tiled``: concatenated along ``dim``), in group order.
    Backward: the reduce-scatter of the cotangent."""
    if _grad_flows(x) and _group(axes) is not None:
        return _AllGatherFn.apply(x, axes, dim, tiled)
    return _all_gather(x, axes, dim, tiled)


def psum(x: torch.Tensor, axes):
    """``lax.psum``. Backward: the psum of the cotangent."""
    if _grad_flows(x) and _group(axes) is not None:
        return _PsumFn.apply(x, axes)
    return _all_reduce("psum", tdist.ReduceOp.SUM, x, axes)


def pmax(x: torch.Tensor, axes):
    """``lax.pmax``, which takes no gradient (the result is detached)."""
    return _all_reduce("pmax", tdist.ReduceOp.MAX, x.detach(), axes)


def pmean(x: torch.Tensor, axes):
    return psum(x, axes) / get_ctx().axis_size(_axes(axes))


def psum_scatter(x: torch.Tensor, axes, dim: int = 0):
    """``lax.psum_scatter(tiled=True)``: the group's sum, of which this
    rank keeps block ``axis_index(axes)`` along ``dim``. Backward: the
    tiled all-gather of the cotangent."""
    if _grad_flows(x) and _group(axes) is not None:
        return _PsumScatterFn.apply(x, axes, dim)
    return _psum_scatter(x, axes, dim)


def all_to_all(x: torch.Tensor, axes, split_dim: int, concat_dim: int):
    """``lax.all_to_all(tiled=True)``: ``x`` split into n blocks along
    ``split_dim``, block j sent to group rank j, and the n blocks received
    concatenated along ``concat_dim`` in group order. Backward: the
    inverse all-to-all of the cotangent."""
    if _grad_flows(x) and _group(axes) is not None:
        return _AllToAllFn.apply(x, axes, split_dim, concat_dim)
    return _all_to_all(x, axes, split_dim, concat_dim)


# ---------------------------------------------------------------------------
# Tensor parallelism over the model axes
# ---------------------------------------------------------------------------


def tp_size() -> int:
    """The model axes' size t (1 without a mesh)."""
    ctx = get_ctx()
    return ctx.axis_size(ctx.model_axes) if ctx.active else 1


def tp_rank() -> int:
    """This rank's index over the model axes (0 without a mesh)."""
    ctx = get_ctx()
    return axis_index(ctx.model_axes) if ctx.active else 0


def split_block(local: int, whole: int) -> bool:
    """Whether a leaf's dimension of ``local`` entries is this rank's block
    of a dimension of ``whole`` split over the model axes (False where the
    leaf is whole)."""
    if local == whole:
        return False
    t = tp_size()
    if t <= 1 or local * t != whole:
        raise ValueError(f"a dimension of {local} is neither whole ({whole}) "
                         f"nor a block of it over {t} model ranks")
    return True


def model_block(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """This rank's block of ``n`` entries of ``x`` along ``dim``."""
    return x.narrow(dim, tp_rank() * n, n)


def gather_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The model group's blocks of ``x`` concatenated along ``dim``."""
    return all_gather(x, get_ctx().model_axes, dim=dim, tiled=True)


def psum_model(x: torch.Tensor) -> torch.Tensor:
    return psum(x, get_ctx().model_axes)


def gather_cols(parts):
    """Each of ``parts`` (tensors of one leading shape, the rank's block of
    columns of each) made whole along the last dimension, with ONE
    all-gather over the model axes: the blocks are packed side by side,
    gathered stacked, and unpacked in rank order."""
    if len(parts) == 1:
        return [gather_model(parts[0], parts[0].dim() - 1)]
    widths = [p.shape[-1] for p in parts]
    dt = torch.promote_types(parts[0].dtype, parts[-1].dtype)
    packed = torch.cat([p.to(dt) for p in parts], dim=-1)
    out = all_gather(packed, get_ctx().model_axes, dim=0)   # (t, ..., W)
    whole, off = [], 0
    for p, w in zip(parts, widths):
        blk = out[..., off:off + w].movedim(0, -2)           # (..., t, w)
        whole.append(blk.reshape(*p.shape[:-1], -1).to(p.dtype))
        off += w
    return whole
