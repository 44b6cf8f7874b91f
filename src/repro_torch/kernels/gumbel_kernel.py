"""Wrapper of the CUDA kernel ``gumbel_argmax`` (``csrc/gumbel.cu``).

Replaces the Pallas kernel ``src/repro/kernels/gumbel_kernel.py:73``:
``argmax_v(z + G(hash(seed, b, v)))`` in one read of z, the first maximum
winning. Bound by the 4 bytes of z per element it must read and, as much,
by the hash and the two accurate ``logf`` of every element. Plain version:
``ref.gumbel_argmax_ref``, to whose tokens it is equal.

A row is split over a thread-block cluster of C CTAs, as ``shvs_masses``
splits it (:func:`split`); each CTA streams a contiguous range with
16-byte loads and reduces it to one packed (value, column) key, and rank
0 merges the C keys in rank order through distributed shared memory and
writes the token. One launch; the only allocation is the (B,) int32
output. B ≤ 65535. The noise is computed by a copy of the accurate
``logf`` without its special-case paths, which :func:`noise_check` holds
to ``logf`` bit for bit over every hash value.
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

_ARGTYPES = [ctypes.c_void_p, ctypes.c_uint, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_FN = None          # the entry point, looked up once (the host's cost a call)


def split(B: int, V: int) -> dict:
    """The launch the kernel makes for (B, V): cluster size C, columns a
    CTA (chunk), threads a CTA, and how many of its clusters the current
    card holds at once (``cudaOccupancyMaxActiveClusters``; B of them
    make one wave)."""
    out = (ctypes.c_int * 4)()
    _build.library().gumbel_argmax_split.argtypes = [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    _build.library().gumbel_argmax_split(B, V, out)
    C, chunk, threads, resident = out
    return {"C": C, "grid": (C, B), "chunk": chunk, "threads": threads,
            "max_active_clusters": resident}


def noise_check(device) -> int:
    """How many of the 2^32 hash values h give a noise that differs in any
    bit from ``-logf(-logf(u(h)))`` on ``device`` (0 is the claim). Not a
    launch of the path: it does not count in :data:`launches`."""
    bad = torch.zeros((1,), dtype=torch.int64, device=device)
    fn = _build.function("gumbel_noise_check",
                         [ctypes.c_void_p, ctypes.c_void_p])
    with torch.cuda.device(device):
        rc = fn(bad.data_ptr(), _build.stream(device))
    _build.check_rc("gumbel_noise_check", rc)
    return int(bad.item())


def gumbel_argmax(z, seed: int, row0: int = 0):
    """z (B, V) f32; ``seed`` the uint32 bits of the reference's int32
    seed; ``row0`` the batch row of z's first row (the hash's b is row0
    plus the operand row). Returns tokens (B,) int32."""
    global launches, _FN
    dev = _build.cuda_device(z)
    B, V = z.shape
    zp = _build.ptr(z, "z", torch.float32, (B, V), dev)
    tokens = torch.empty((B,), dtype=torch.int32, device=dev)
    if _FN is None:
        _FN = _build.function("gumbel_argmax", _ARGTYPES)
    with torch.cuda.device(dev):
        rc = _FN(zp, int(seed) & 0xFFFFFFFF, int(row0), tokens.data_ptr(),
                 B, V, _build.stream(dev))
    _build.check_rc(NAME, rc)
    with _build.COUNT_LOCK:     # replicas launch from their own threads
        launches += 1
    return tokens
