"""Meshes: their shape alone, and the process meshes behind them.

:class:`MeshShape` is a mesh's axis names and sizes with no processes
behind it, the counterpart of ``jax.sharding.AbstractMesh``: the sharding
rules (``launch/sharding.py``) read only these, so they can be held at
16×16 and 2×16×16 without 512 ranks. :func:`make_local_mesh` and
:func:`make_production_mesh` build ``torch.distributed`` device meshes
over the ranks of the default process group, which the launcher
initialises (address, world size and rank given explicitly).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Sequence, Tuple


class MeshShape:
    """Axis names and sizes; ``shape`` maps name -> size in mesh order, as
    a jax mesh's does."""

    def __init__(self, sizes: Sequence[int], names: Sequence[str]):
        if len(sizes) != len(names):
            raise ValueError((sizes, names))
        self.axis_names: Tuple[str, ...] = tuple(names)
        self.shape = OrderedDict(zip(self.axis_names,
                                     (int(s) for s in sizes)))

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape.values():
            n *= s
        return n

    @classmethod
    def of(cls, mesh) -> "MeshShape":
        """The shape of a ``DeviceMesh`` (or of another ``MeshShape``)."""
        if isinstance(mesh, MeshShape):
            return mesh
        return cls(tuple(mesh.mesh.shape), mesh.mesh_dim_names)

    def __repr__(self):
        return f"MeshShape({dict(self.shape)})"


PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def production_shape(*, multi_pod: bool = False) -> MeshShape:
    """16×16 = 256 chips a pod; 2 pods = 512 with a leading 'pod' axis."""
    return MeshShape(*PRODUCTION[multi_pod])


def _device_type() -> str:
    import torch
    import torch.distributed as tdist
    return "cuda" if tdist.get_backend() == "nccl" and \
        torch.cuda.is_available() else "cpu"


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """The production device mesh, (16, 16) or (2, 16, 16). Needs exactly
    that many ranks; raises when the world is smaller, as the reference
    does."""
    import torch.distributed as tdist
    from torch.distributed.device_mesh import init_device_mesh
    shape = production_shape(multi_pod=multi_pod)
    have = tdist.get_world_size() if tdist.is_initialized() else 1
    if have < shape.size:
        raise RuntimeError(
            f"need {shape.size} ranks for mesh {tuple(shape.shape.values())},"
            f" have {have}")
    return init_device_mesh(device_type or _device_type(),
                            tuple(shape.shape.values()),
                            mesh_dim_names=shape.axis_names)


def make_local_mesh(data: int = 1, model: int = 1, device_type=None):
    """A (data, model) device mesh over the world's ranks (data·model of
    them) — used by the distribution tests and the smoke run."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type or _device_type(), (data, model),
                            mesh_dim_names=("data", "model"))


def mesh_axes(mesh):
    """(batch_axes, model_axes) naming convention for a production mesh."""
    names = MeshShape.of(mesh).axis_names
    batch = tuple(a for a in names if a in ("pod", "data"))
    model = tuple(a for a in names if a == "model")
    return batch, model
