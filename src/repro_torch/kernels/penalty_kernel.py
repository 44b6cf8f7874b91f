"""Wrapper of the CUDA kernel ``penalty_scale`` (``csrc/penalty.cu``).

Replaces the Pallas kernel ``src/repro/kernels/penalty_kernel.py:55``.
Eq. 1 penalties then ``/ max(τ, 1e-6)`` in one elementwise pass: bound by
the 16 bytes each element moves (12 read, 4 written). Plain version:
``ref.penalty_ref``, to which it is bit-equal (``-fmad=false``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NAME = "penalty_scale"
SOURCE = "src/repro_torch/kernels/csrc/penalty.cu"
REPLACES = "src/repro/kernels/penalty_kernel.py:55"

#: kernel launches since the last reset (``ops.reset_launch_counts``)
launches = 0

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]


def penalty_scale(logits, counts_p, counts_o, repetition, presence,
                  frequency, temperature) -> torch.Tensor:
    """logits (B, V) f32; counts (B, V) int32; params (B,) f32 → (B, V)."""
    global launches
    if _build.shape_only(logits):
        return torch.empty_like(logits)
    dev = _build.cuda_device(logits)
    B, V = logits.shape
    f32, i32 = torch.float32, torch.int32
    out = torch.empty_like(logits)
    args = [_build.ptr(logits, "logits", f32, (B, V), dev),
            _build.ptr(counts_p, "counts_p", i32, (B, V), dev),
            _build.ptr(counts_o, "counts_o", i32, (B, V), dev)]
    args += [_build.ptr(t, n, f32, (B,), dev) for t, n in (
        (repetition, "repetition"), (presence, "presence"),
        (frequency, "frequency"), (temperature, "temperature"))]
    args.append(out.data_ptr())
    fn = _build.function("penalty_scale", _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(*args, B, V, _build.stream(dev))
    _build.check_rc(NAME, rc)
    with _build.COUNT_LOCK:     # replicas launch from their own threads
        launches += 1
    return out
