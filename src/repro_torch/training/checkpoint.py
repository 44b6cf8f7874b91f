"""Checkpointing: a tree of tensors <-> ``.npz`` with key-path
flattening, step resume — the reference's file layout, so a checkpoint
written by either package restores in the other.

``params.npz`` holds the parameters under their paths joined by ``/``
(``emb/tok``, ``stack/attn/w_q``); ``opt.npz`` the ``AdamWState`` under
the reference's names (``.step``, ``.mu/emb/tok``, ``.nu/...``);
``meta.json`` the step and any metadata. A bf16 leaf is written as the
reference writes it, 2-byte raw (``V2``) entries holding its bits, and
such an entry is read back by reinterpreting the bits as bf16 (no
``ml_dtypes`` needed). The reference's own restore cannot read that
entry (ROADMAP Fault 8).
"""
from __future__ import annotations

import json
import os
from typing import Any, Tuple

import numpy as np
import torch


def _items(tree):
    """(key, child) pairs of a dict or a NamedTuple (fields named
    ``.field``, as ``jax.tree_util`` names them)."""
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    return [(f".{f}", getattr(tree, f)) for f in tree._fields]


def _is_node(tree) -> bool:
    return isinstance(tree, dict) or (isinstance(tree, tuple)
                                      and hasattr(tree, "_fields"))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _flatten(tree, prefix: str = "") -> dict:
    if not _is_node(tree):
        return {prefix: _to_numpy(tree)}
    flat = {}
    for k, v in _items(tree):
        flat.update(_flatten(v, f"{prefix}/{k}" if prefix else k))
    return flat


def _tensor_like(arr: np.ndarray, leaf: torch.Tensor) -> torch.Tensor:
    """``arr`` as a tensor of ``leaf``'s dtype on its device; a 2-byte raw
    (or ml_dtypes bfloat16) entry holds bf16 bits."""
    if (arr.dtype.kind == "V" and arr.dtype.itemsize == 2) or \
            arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                             .copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device=leaf.device, dtype=leaf.dtype)


def save_checkpoint(path: str, params, opt_state=None, step: int = 0,
                    metadata: dict | None = None) -> None:
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "params.npz"), **_flatten(params))
    if opt_state is not None:
        np.savez(os.path.join(path, "opt.npz"), **_flatten(opt_state))
    meta = {"step": step, **(metadata or {})}
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)


def _rebuild(template, npz, prefix: str = ""):
    if not _is_node(template):
        arr = npz[prefix]
        assert arr.shape == tuple(template.shape), \
            (prefix, arr.shape, tuple(template.shape))
        return _tensor_like(arr, template)
    kids = [_rebuild(v, npz, f"{prefix}/{k}" if prefix else k)
            for k, v in _items(template)]
    if isinstance(template, dict):
        return dict(zip(template, kids))
    return type(template)(*kids)


def restore_checkpoint(path: str, params_template, opt_template=None
                       ) -> Tuple[Any, Any, int]:
    """Restore into the template's tree structure, dtypes and devices."""
    with np.load(os.path.join(path, "params.npz")) as data:
        params = _rebuild(params_template, data)
    opt_state = None
    opt_path = os.path.join(path, "opt.npz")
    if opt_template is not None and os.path.exists(opt_path):
        with np.load(opt_path) as data:
            opt_state = _rebuild(opt_template, data)
    with open(os.path.join(path, "meta.json")) as f:
        step = json.load(f)["step"]
    return params, opt_state, step
