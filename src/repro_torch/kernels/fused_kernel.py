"""Wrapper of the CUDA kernel ``fused_sample`` (``csrc/fused.cu``).

Replaces the Pallas kernel ``src/repro/kernels/fused_kernel.py:127``:
penalties → temperature → streaming masses and top-K → truncation-first
filter → restricted Gumbel-max draw. Bound by the 12 bytes per element of
logits and counts it must read. Plain version: ``ref.fused_sample_ref``
with the same ``block_v`` (tokens, exact and kept equal; alpha to
rounding).

A row is split over a thread-block cluster of C CTAs of 512 threads, each
owning a contiguous range of the padded vocabulary: C is the smallest
power of two with B·C ≥ 528, at most 16, then cut so that no CTA but the
last gets fewer than 2048 columns (16 at B = 8, V = 49152 and at B = 64,
V = 151936). Each CTA keeps 4 bytes a column of its range in shared
memory (at most 32768 columns, so Vp ≤ 16 · 32768) and selects its K
largest keys; the C lists merge pairwise through distributed shared
memory and rank 0 draws. Dynamic shared memory a CTA: 4 · chunk + 16 KB +
8 · L bytes, L = K rounded up to a power of two (30 KB at B = 8,
V = 49152, K = 256). K ≤ 1024.
:func:`split` gives the launch's numbers.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NAME = "fused_sample"
SOURCE = "src/repro_torch/kernels/csrc/fused.cu"
REPLACES = "src/repro/kernels/fused_kernel.py:127"
MAX_K = 1024
MAX_VP = 16 * 32768

#: kernel launches since the last reset (``ops.reset_launch_counts``)
launches = 0

_ARGTYPES = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def split(B: int, Vp: int, K: int) -> dict:
    """The launch the kernel makes for (B, Vp, K): cluster size C, columns
    a CTA (chunk), list length L, dynamic shared bytes and threads a CTA."""
    out = (ctypes.c_int * 5)()
    _build.library().fused_sample_split.argtypes = [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    _build.library().fused_sample_split(B, Vp, K, out)
    C, chunk, L, smem, threads = out
    return {"C": C, "grid": (C, B), "chunk": chunk, "L": L,
            "smem_bytes": smem, "threads": threads}


def fused_sample(logits, counts_p, counts_o, repetition, presence, frequency,
                 temperature, top_k, top_p, min_p, u_row, hot_mask, *,
                 k_cap: int, block_v: int):
    """logits (B, V) f32; counts (B, V) int32; per-row params (B,) (top_k
    int32, the rest f32); u_row (B,) f32; hot_mask (V,) bool.

    The vocabulary is treated as padded to a multiple of ``block_v`` (the
    plain version's tiling) and K = min(k_cap, padded V). Returns
    (tokens int32, exact bool, alpha f32, kept int32), each (B,).
    """
    global launches
    dev = _build.cuda_device(logits)
    B, V = logits.shape
    Vp = -(-V // block_v) * block_v
    K = min(k_cap, Vp)
    if K > MAX_K or Vp > MAX_VP:
        raise ValueError(f"fused_sample: K={K}, padded V={Vp}: the kernel "
                         f"takes K <= {MAX_K} and a padded V <= {MAX_VP}")
    f32, i32 = torch.float32, torch.int32
    args = [_build.ptr(logits, "logits", f32, (B, V), dev),
            _build.ptr(counts_p, "counts_p", i32, (B, V), dev),
            _build.ptr(counts_o, "counts_o", i32, (B, V), dev)]
    for t, n, dt in ((repetition, "repetition", f32),
                     (presence, "presence", f32),
                     (frequency, "frequency", f32),
                     (temperature, "temperature", f32), (top_k, "top_k", i32),
                     (top_p, "top_p", f32), (min_p, "min_p", f32),
                     (u_row, "u_row", f32)):
        args.append(_build.ptr(t, n, dt, (B,), dev))
    args.append(_build.ptr(hot_mask, "hot_mask", torch.bool, (V,), dev))
    tokens = torch.empty((B,), dtype=i32, device=dev)
    exact = torch.empty((B,), dtype=torch.bool, device=dev)
    alpha = torch.empty((B,), dtype=f32, device=dev)
    kept = torch.empty((B,), dtype=i32, device=dev)
    args += [t.data_ptr() for t in (tokens, exact, alpha, kept)]
    fn = _build.function("fused_sample", _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(*args, B, V, Vp, K, _build.stream(dev))
    _build.check_rc(NAME, rc)
    launches += 1
    return tokens, exact, alpha, kept
