"""Wrapper of the CUDA kernel ``shvs_masses`` (``csrc/shvs.cu``).

Replaces the Pallas kernel ``src/repro/kernels/shvs_kernel.py:67``. One
read of z per row gives (m, S_hot, S_tail, tail_max) (paper Eq. 6–7):
bound by the 4 bytes of z per element plus the hot mask. Plain version:
``ref.shvs_mass_ref`` (m and tail_max equal, sums to rounding; two
launches give the same bits).

A row is split over a thread-block cluster of C CTAs of 256 threads, each
streaming a contiguous range with 16-byte loads; rank 0 merges the C
partial states in rank order through distributed shared memory. C is the
smallest power of two with B·C ≥ 528, at most 16, then cut so that no
CTA but the last gets fewer than 2048 columns (16 at B = 8, V = 49152 and
at B = 64, V = 151936). No dynamic shared memory; B ≤ 65535.
:func:`split` gives the launch's numbers.
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


def split(B: int, V: int) -> dict:
    """The launch the kernel makes for (B, V): cluster size C, columns a
    CTA (chunk) and threads a CTA."""
    out = (ctypes.c_int * 3)()
    _build.library().shvs_masses_split.argtypes = [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    _build.library().shvs_masses_split(B, V, out)
    C, chunk, threads = out
    return {"C": C, "grid": (C, B), "chunk": chunk, "threads": threads}


def shvs_masses(z, hot_mask):
    """z (B, V) f32; hot_mask (V,) bool → (m, s_hot, s_tail, tail_max),
    each (B,) f32."""
    global launches
    if _build.shape_only(z):
        return tuple(torch.empty((4, z.shape[0]), dtype=torch.float32,
                                 device=z.device))
    dev = _build.cuda_device(z)
    B, V = z.shape
    outs = torch.empty((4, B), dtype=torch.float32, device=dev)
    fn = _build.function("shvs_masses", _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(_build.ptr(z, "z", torch.float32, (B, V), dev),
                _build.ptr(hot_mask, "hot_mask", torch.bool, (V,), dev),
                *(o.data_ptr() for o in outs), B, V, _build.stream(dev))
    _build.check_rc(NAME, rc)
    with _build.COUNT_LOCK:     # replicas launch from their own threads
        launches += 1
    return outs[0], outs[1], outs[2], outs[3]
