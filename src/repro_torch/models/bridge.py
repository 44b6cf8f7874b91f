"""Bring weights made by the reference package into the port.

``from_jax_params`` takes the reference ``Model.init`` tree with every leaf
converted to numpy (``jax.tree_util.tree_map(np.asarray, params)``) and
returns the same tree of torch tensors: same keys, same ``(in, out)``
layout, the stacked leading L axis kept. Nothing here imports JAX.
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
