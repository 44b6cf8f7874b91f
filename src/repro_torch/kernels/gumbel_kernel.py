"""Wrapper of the CUDA kernel ``gumbel_argmax`` (``csrc/gumbel.cu``).

Replaces the Pallas kernel ``src/repro/kernels/gumbel_kernel.py:73``:
``argmax_v(z + G(hash(seed, b, v)))`` in one read of z, the first maximum
winning. Bound by the 4 bytes of z per element it must read. Each row is
split over many blocks whose packed (value, column) keys merge with
``atomicMax``. Plain version: ``ref.gumbel_argmax_ref``, to whose tokens
it is equal.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NAME = "gumbel_argmax"
SOURCE = "src/repro_torch/kernels/csrc/gumbel.cu"
REPLACES = "src/repro/kernels/gumbel_kernel.py:73"

#: kernel launches since the last reset (``ops.reset_launch_counts``)
launches = 0

_ARGTYPES = [ctypes.c_void_p, ctypes.c_uint, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def gumbel_argmax(z, seed: int):
    """z (B, V) f32; ``seed`` the uint32 bits of the reference's int32
    seed. Returns tokens (B,) int32."""
    global launches
    dev = _build.cuda_device(z)
    B, V = z.shape
    zp = _build.ptr(z, "z", torch.float32, (B, V), dev)
    keys = torch.empty((B,), dtype=torch.int64, device=dev)
    tokens = torch.empty((B,), dtype=torch.int32, device=dev)
    fn = _build.function("gumbel_argmax", _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(zp, int(seed) & 0xFFFFFFFF, keys.data_ptr(),
                tokens.data_ptr(), B, V, _build.stream(dev))
    _build.check_rc(NAME, rc)
    launches += 1
    return tokens
