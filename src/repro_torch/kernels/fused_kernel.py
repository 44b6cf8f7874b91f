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
largest keys; the C lists merge pairwise and rank 0 draws. K is any
value up to the padded V, by one of two paths (:func:`split` says which):

* ``shared``: each list, L = K rounded up to a power of two keys, stays in
  shared memory and merges through distributed shared memory. Dynamic
  shared memory a CTA: 4 · chunk + 16 KB + 8 · L bytes, at most the
  card's opt-in limit (227 KB on the H100: K ≤ 16384 at B = 8, V = 49152
  and at B = 64, V = 151936);
* ``global``: beyond that, each CTA's sorted list of L = min(K, chunk)
  rounded up to a power of two keys goes to a workspace of B · C · L keys
  of 8 bytes in device memory, where the lists merge keeping every key.
  The wrapper allocates it and keeps it per device and size (134 MB at
  B = 64, V = 151936, K = Vp; 4 MB at B = 8, V = 49152) for the life of
  the process, so one first made while a CUDA graph is captured lives as
  long as the graph. Launches on different streams of one device must not
  share it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NAME = "fused_sample"
SOURCE = "src/repro_torch/kernels/csrc/fused.cu"
REPLACES = "src/repro/kernels/fused_kernel.py:127"
MAX_VP = 16 * 32768

#: kernel launches since the last reset (``ops.reset_launch_counts``)
launches = 0

_ARGTYPES = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2

#: the global path's workspaces, one per (device, keys), and the keys a
#: launch needs, per (device, B, Vp, K, path)
_WORKSPACE: dict = {}
_WORKSPACE_KEYS: dict = {}


def split(B: int, Vp: int, K: int, path: str = None) -> dict:
    """The launch the kernel makes for (B, Vp, K) on the current device:
    cluster size C, columns a CTA (chunk), list length L, dynamic shared
    bytes, threads a CTA, the path (``shared`` or ``global``), the global
    path's workspace in keys (0 on the shared path) and the clusters the
    card holds at once. ``path="global"`` asks for the global path where
    the shared one would fit. Raises if the kernel does not take (B, Vp,
    K)."""
    out = (ctypes.c_int * 7)()
    _build.library().fused_sample_split.argtypes = [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    _build.library().fused_sample_split(B, Vp, K, _force_global(path), out)
    C, chunk, L, smem, threads, glob, clusters = out
    if C < 0:
        raise ValueError(f"fused_sample: the kernel does not take B={B}, "
                         f"padded V={Vp}, K={K}")
    return {"C": C, "grid": (C, B), "chunk": chunk, "L": L,
            "smem_bytes": smem, "threads": threads,
            "path": "global" if glob else "shared",
            "workspace_keys": B * C * L if glob else 0,
            "max_active_clusters": clusters}


def _force_global(path) -> int:
    if path not in (None, "global"):
        raise ValueError(f"path: None or 'global', got {path!r}")
    return int(path == "global")


def _workspace(dev: torch.device, B: int, Vp: int, K: int, path):
    """The global path's workspace pointer for this launch, or None on the
    shared path. Call with ``dev`` current."""
    keys = _WORKSPACE_KEYS.get((dev, B, Vp, K, path))
    if keys is None:
        keys = _WORKSPACE_KEYS[(dev, B, Vp, K, path)] = \
            split(B, Vp, K, path)["workspace_keys"]
    if not keys:
        return None
    ws = _WORKSPACE.get((dev, keys))
    if ws is None:
        ws = _WORKSPACE[(dev, keys)] = torch.empty(
            (keys,), dtype=torch.int64, device=dev)
    return ws.data_ptr()


def fused_sample(logits, counts_p, counts_o, repetition, presence, frequency,
                 temperature, top_k, top_p, min_p, u_row, hot_mask, *,
                 k_cap: int, block_v: int, path: str = None):
    """logits (B, V) f32; counts (B, V) int32; per-row params (B,) (top_k
    int32, the rest f32); u_row (B,) f32; hot_mask (V,) bool.

    The vocabulary is treated as padded to a multiple of ``block_v`` (the
    plain version's tiling) and K = min(k_cap, padded V). The kernel takes
    the shared path where it fits, else the global one; ``path="global"``
    asks for the global path anyway. Returns (tokens int32, exact bool,
    alpha f32, kept int32), each (B,).
    """
    global launches
    if _build.shape_only(logits):
        B = logits.shape[0]
        return tuple(torch.empty((B,), dtype=dt, device=logits.device)
                     for dt in (torch.int32, torch.bool, torch.float32,
                                torch.int32))
    dev = _build.cuda_device(logits)
    B, V = logits.shape
    Vp = -(-V // block_v) * block_v
    K = min(k_cap, Vp)
    force = _force_global(path)
    if Vp > MAX_VP:
        raise ValueError(f"fused_sample: padded V={Vp}: the kernel takes a "
                         f"padded V <= {MAX_VP}")
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
        rc = fn(*args, B, V, Vp, K, force, _workspace(dev, B, Vp, K, path),
                _build.stream(dev))
    _build.check_rc(NAME, rc)
    with _build.COUNT_LOCK:     # replicas launch from their own threads
        launches += 1
    return tokens, exact, alpha, kept
