"""Bring weights made by the reference package into the port.

``from_jax_params`` takes the reference ``Model.init`` tree with every leaf
converted to numpy (``jax.tree_util.tree_map(np.asarray, params)``) and
returns the same tree of torch tensors: same keys, same ``(in, out)``
layout, the stacked leading L axis kept. ``save_npz`` / ``load_npz``
carry the same tree through one ``.npz`` file (keys are the tree's paths
joined by ``/``; a bf16 leaf is stored as its 16-bit pattern under
``<path>@bfloat16``), the layout of ``repro_torch.launch.serve --weights``.
Nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes' bfloat16: same bits
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def from_jax_params(tree, device="cpu"):
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device) for k, v in tree.items()}
    return _tensor(tree, device)


_BF16 = "@bfloat16"


def save_npz(path, tree) -> None:
    """Write a nested dict of numpy arrays (the reference's tree as
    ``jax.tree_util.tree_map(np.asarray, params)`` gives it) to ``path``."""
    flat = {}

    def walk(t, prefix):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{prefix}/{k}" if prefix else k)
            return
        a = np.asarray(t)
        if a.dtype.name == "bfloat16":
            flat[prefix + _BF16] = np.ascontiguousarray(a).view(np.uint16)
        else:
            flat[prefix] = a

    walk(tree, "")
    np.savez(path, **flat)


def load_npz(path, device="cpu"):
    """The tree :func:`save_npz` wrote, as tensors on ``device``."""
    out: dict = {}
    with np.load(path) as f:
        for key in f.files:
            a = f[key]
            if key.endswith(_BF16):
                key = key[:-len(_BF16)]
                t = torch.from_numpy(a.copy()).view(torch.bfloat16)
            else:
                t = torch.from_numpy(a.copy())
            node = out
            *parents, leaf = key.split("/")
            for k in parents:
                node = node.setdefault(k, {})
            node[leaf] = t.to(device)
    return out
