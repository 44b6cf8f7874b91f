"""Paged KV cache — vLLM-style block allocation.

The paged alternative to the contiguous per-slot cache of
``models/transformer.py``:

* a block pool ``(L, num_blocks + 1, block_size, kv, hd)`` per K and V —
  the ``num_blocks`` blocks that block tables name plus one trash block
  (index ``num_blocks``) where dropped writes land;
* a per-slot block table ``(B, max_blocks_per_seq)`` of pool indices
  (-1 = unallocated), on the device, mirrored by the host-side free list
  of :class:`BlockAllocator`;
* ``paged_write`` (a chunk of up to C tokens per slot) and
  ``paged_gather`` (contiguous (L, B, S_view, kv, hd) views).

The device primitives (gather / flat index / scatter) live in
``models/attention.py`` so the transformer stack can attend over the pool
without importing the engine package. Pages change WHERE K/V live, never
their values: attention over the gathered view with the same length mask
equals attention over the contiguous cache. Writes are in place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.models.attention import flat_block_indices, scatter_block_kv
from repro_torch.models.layers import torch_dtype


@dataclass
class PagedCacheConfig:
    block_size: int = 16
    num_blocks: int = 256              # pool size (per layer, shared K/V)
    max_blocks_per_seq: int = 32


def init_paged_cache(cfg: ModelConfig, batch: int, pcfg: PagedCacheConfig,
                     dtype=None, device="cpu"):
    """Device state: pools (with the trash block) + block table + lengths."""
    dtype = dtype or torch_dtype(cfg.dtype)
    shape = (cfg.num_layers, pcfg.num_blocks + 1, pcfg.block_size,
             cfg.num_kv_heads, cfg.resolved_head_dim)
    return {
        "k_pool": torch.zeros(shape, dtype=dtype, device=device),
        "v_pool": torch.zeros(shape, dtype=dtype, device=device),
        "block_table": torch.full((batch, pcfg.max_blocks_per_seq), -1,
                                  dtype=torch.int32, device=device),
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }


class BlockAllocator:
    """Host-side free-list that mirrors the device block table.

    ``ensure`` is atomic: it either grows a slot's allocation to the
    requested coverage or raises without mutating any state, so exhaustion
    is reported deterministically.
    """

    def __init__(self, pcfg: PagedCacheConfig, batch: int):
        self.pcfg = pcfg
        self.free: List[int] = list(range(pcfg.num_blocks))[::-1]
        self.owned: List[List[int]] = [[] for _ in range(batch)]

    def blocks_needed(self, length: int) -> int:
        return -(-max(length, 0) // self.pcfg.block_size)

    @property
    def num_free(self) -> int:
        return len(self.free)

    @property
    def num_live(self) -> int:
        return sum(len(b) for b in self.owned)

    def ensure(self, slot: int, new_length: int) -> List[int]:
        """Grow slot's allocation to cover new_length; returns newly
        assigned block ids. Raises (without allocating anything) if the
        pool cannot cover the request."""
        need = self.blocks_needed(new_length)
        if need > self.pcfg.max_blocks_per_seq:
            raise RuntimeError(
                f"sequence needs {need} blocks > max_blocks_per_seq="
                f"{self.pcfg.max_blocks_per_seq}")
        grow = need - len(self.owned[slot])
        if grow > len(self.free):
            raise RuntimeError("paged KV pool exhausted")
        fresh = [self.free.pop() for _ in range(grow)]
        self.owned[slot].extend(fresh)
        return fresh

    def release(self, slot: int) -> None:
        self.free.extend(reversed(self.owned[slot]))
        self.owned[slot] = []

    def export_slot(self, slot: int) -> List[int]:
        """Detach and return ``slot``'s block ids (the export half of KV
        migration): the caller gathers the blocks' contents first
        (:func:`gather_slot_kv`); exactly ``blocks_needed(length)`` ids
        return to the free list."""
        blocks = list(self.owned[slot])
        self.release(slot)
        return blocks

    def table(self, batch: int) -> np.ndarray:
        t = np.full((batch, self.pcfg.max_blocks_per_seq), -1, np.int32)
        for s, blocks in enumerate(self.owned):
            t[s, :len(blocks)] = blocks
        return t


def paged_write(cache: dict, layer_kv: Tuple[torch.Tensor, torch.Tensor],
                lens: torch.Tensor, pcfg: PagedCacheConfig,
                active: Optional[torch.Tensor] = None,
                counts: Optional[torch.Tensor] = None) -> dict:
    """Write a chunk of tokens per slot into the pools at position ``lens``.

    layer_kv: (k, v) each (L, B, C, kv, hd) — all layers' new entries
    (C = 1 is the decode case). ``counts`` (B,) limits the valid tokens per
    row (defaults to C); ``active`` (B,) bool zeroes a row's count. The
    block table must already cover [lens, lens+counts)
    (``BlockAllocator.ensure``); writes landing on an unallocated or
    out-of-range block go to the trash block. Returns the cache with
    ``len`` advanced (the pools are written in place)."""
    k_new, v_new = layer_kv
    B, C = k_new.shape[1], k_new.shape[2]
    dev = k_new.device
    if counts is None:
        counts = torch.full((B,), C, dtype=torch.int32, device=dev)
    if active is not None:
        counts = torch.where(active, counts, 0)
    valid = torch.arange(C, device=dev)[None, :] < counts[:, None]
    flat = flat_block_indices(cache["block_table"], lens, valid,
                              pcfg.block_size, pcfg.num_blocks)
    scatter_block_kv(cache["k_pool"], k_new, flat)
    scatter_block_kv(cache["v_pool"], v_new, flat)
    cache = dict(cache)
    cache["len"] = cache["len"] + counts.to(torch.int32)
    return cache


def gather_slot_kv(cache: dict, blocks: List[int], length: int,
                   pcfg: PagedCacheConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ONE slot's contiguous ``(L, length, kv, hd)`` K/V from its block
    list (the read of a KV-migration export): a bitwise copy on the pool's
    device, which later writes to the blocks do not reach."""
    pool = cache["k_pool"]
    L, trail = pool.shape[0], tuple(pool.shape[3:])
    if length <= 0 or not blocks:
        z = torch.zeros((L, 0) + trail, dtype=pool.dtype, device=pool.device)
        return z, z.clone()
    assert len(blocks) * pcfg.block_size >= length, \
        "block list does not cover the requested length"
    idx = torch.as_tensor(blocks, dtype=torch.long, device=pool.device)

    def gather(p):
        g = p[:, idx]                          # (L, nb, bs, kv, hd)
        return g.reshape(L, -1, *trail)[:, :length].contiguous()

    return gather(cache["k_pool"]), gather(cache["v_pool"])


def scatter_slot_kv(cache: dict, blocks: List[int], k, v,
                    pcfg: PagedCacheConfig) -> dict:
    """Write contiguous ``(L, T, kv, hd)`` K/V into ``blocks`` (freshly
    allocated on the importing side), in place — the import half of KV
    migration. ``k``/``v``: tensors or arrays on any device."""
    L, T = k.shape[0], k.shape[1]
    nb = len(blocks)
    assert nb * pcfg.block_size >= T, "not enough blocks for the payload"
    pool = cache["k_pool"]
    idx = torch.as_tensor(blocks, dtype=torch.long, device=pool.device)

    def put(p, rows):
        rows = torch.as_tensor(np.asarray(rows)) \
            if not isinstance(rows, torch.Tensor) else rows
        rows = rows.to(device=p.device, dtype=p.dtype)
        pad = nb * pcfg.block_size - T
        if pad:
            rows = torch.cat([rows, rows.new_zeros((L, pad) +
                                                   tuple(rows.shape[2:]))], 1)
        p[:, idx] = rows.reshape(L, nb, pcfg.block_size, *rows.shape[2:])

    put(cache["k_pool"], k)
    put(cache["v_pool"], v)
    return cache


def paged_gather(cache: dict, pcfg: PagedCacheConfig):
    """Contiguous (L, B, S_view, kv, hd) K/V views plus the length vector;
    S_view = max_blocks_per_seq * block_size."""
    bt = torch.clamp(cache["block_table"], min=0).long()   # (B, MB)

    def gather(pool):
        g = pool[:, bt]                        # (L, B, MB, bs, kv, hd)
        L, B, MB = g.shape[:3]
        return g.reshape(L, B, MB * pcfg.block_size, *pool.shape[3:])

    return gather(cache["k_pool"]), gather(cache["v_pool"]), cache["len"]
