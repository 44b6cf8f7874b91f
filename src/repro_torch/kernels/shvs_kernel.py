"""Wrapper of the CUDA kernel ``shvs_masses`` (``csrc/shvs.cu``).

Replaces the Pallas kernel ``src/repro/kernels/shvs_kernel.py:67``. One
read of z per row gives (m, S_hot, S_tail, tail_max) (paper Eq. 6–7):
bound by the 4 bytes of z per element plus the hot mask. Plain version:
``ref.shvs_mass_ref`` (m and tail_max equal, sums to rounding).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NAME = "shvs_masses"
SOURCE = "src/repro_torch/kernels/csrc/shvs.cu"
REPLACES = "src/repro/kernels/shvs_kernel.py:67"

#: kernel launches since the last reset (``ops.reset_launch_counts``)
launches = 0

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]


def shvs_masses(z, hot_mask):
    """z (B, V) f32; hot_mask (V,) bool → (m, s_hot, s_tail, tail_max),
    each (B,) f32."""
    global launches
    dev = _build.cuda_device(z)
    B, V = z.shape
    outs = torch.empty((4, B), dtype=torch.float32, device=dev)
    fn = _build.function("shvs_masses", _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(_build.ptr(z, "z", torch.float32, (B, V), dev),
                _build.ptr(hot_mask, "hot_mask", torch.bool, (V,), dev),
                *(o.data_ptr() for o in outs), B, V, _build.stream(dev))
    _build.check_rc(NAME, rc)
    launches += 1
    return outs[0], outs[1], outs[2], outs[3]
