"""Attention: GQA with RoPE, optional qk-norm and sliding window.

Written as the einsum/softmax it is in the reference (scores and the
weighted sum accumulate in float32), not as a fused library attention.

* ``attend_full``   — direct masked softmax (train/prefill).
* ``attend_decode`` — one query token against a KV cache with a length
  mask; with ``ring=True`` the cache is a sliding-window ring buffer.
* ``attend_chunk_cached`` — C prompt tokens per row at per-row offsets
  against the cache (chunked prefill).

KV caches are per-layer ``(B, S_cache, kv_heads, head_dim)``. A paged
cache keeps K/V in a block pool instead; attention runs over a gathered
contiguous view of it (``gather_block_view``), so pages change where K/V
live, never their values.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.models.layers import apply_rope, matmul, rms_norm

NEG_INF = -1e30


def _project_qkv(params, x, cfg: ModelConfig, positions, rope_tables=None):
    """Project to q/k/v, apply qk-norm + RoPE. Returns (q, k, v) with shapes
    (B, S, nh, hd), (B, S, nkv, hd), (B, S, nkv, hd). ``rope_tables``: the
    forward's shared cos/sin, if already made."""
    hd = cfg.resolved_head_dim
    nh, nkv = cfg.num_heads, cfg.num_kv_heads
    B, S = x.shape[0], x.shape[1]
    q = matmul(x, params["w_q"]).reshape(B, S, nh, hd)
    k = matmul(x, params["w_k"]).reshape(B, S, nkv, hd)
    v = matmul(x, params["w_v"]).reshape(B, S, nkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.rmsnorm_eps)
        k = rms_norm(k, params["k_norm"], cfg.rmsnorm_eps)
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta, rope_tables)
        k = apply_rope(k, positions, cfg.rope_theta, rope_tables)
    return q, k, v


def _expand_gqa(q, nkv: int):
    """(B, S, nh, hd) -> (B, S, nkv, group, hd)."""
    B, S, nh, hd = q.shape
    return q.reshape(B, S, nkv, nh // nkv, hd)


def _attend_scores_softmax(q, k, v, mask, scale):
    """q: (B,Sq,nkv,g,hd)  k/v: (B,Skv,nkv,hd)  mask: (B,1,Sq,Skv) bool."""
    scores = torch.einsum("bqngh,bknh->bngqk", q.float(), k.float()) * scale
    scores = torch.where(mask[:, :, None, :, :], scores, NEG_INF)
    probs = torch.softmax(scores, -1)
    out = torch.einsum("bngqk,bknh->bqngh", probs.to(v.dtype).float(),
                       v.float())
    return out.to(v.dtype)


def attend_full(q, k, v, *, causal: bool, window: int):
    """Direct attention. q: (B,Sq,nkv,g,hd); k,v: (B,Skv,nkv,hd)."""
    B, Sq = q.shape[0], q.shape[1]
    Skv = k.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    qi = torch.arange(Sq, device=q.device)[:, None]
    kj = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kj <= qi
    if window:
        mask &= kj > qi - window
    mask = mask[None].expand(B, Sq, Skv)
    return _attend_scores_softmax(q, k, v, mask[:, None], scale)


def attend_decode(q, cache_k, cache_v, kv_len, *, window: int = 0,
                  ring: bool = False):
    """Single-step decode attention.

    q: (B, 1, nkv, g, hd); cache_k/v: (B, S_cache, nkv, hd);
    kv_len: (B,) number of valid entries. With ``ring=True`` the cache is a
    ring buffer (sliding window) and every slot < min(len, S_cache) is valid.
    """
    S = cache_k.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bngh,bknh->bngk", q[:, 0].float(),
                          cache_k.float()) * scale
    kj = torch.arange(S, device=q.device)[None, :]
    if ring:
        valid = kj < torch.clamp(kv_len, max=S)[:, None]
    else:
        valid = kj < kv_len[:, None]
        if window:
            valid &= kj >= (kv_len[:, None] - window)
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, -1)
    out = torch.einsum("bngk,bknh->bngh", probs.to(cache_v.dtype).float(),
                       cache_v.float())
    return out[:, None].to(cache_v.dtype)  # (B, 1, nkv, g, hd)


def attend_chunk_cached(q, cache_k, cache_v, offsets):
    """Continue-prefill attention: C query tokens per row at per-row offsets
    against the (already written) KV cache.

    q: (B, C, nkv, g, hd); cache_k/v: (B, Sc, nkv, hd); offsets: (B,) valid
    cache entries BEFORE this chunk. Query i of row b sits at position
    offsets[b] + i and attends to cache slots <= offsets[b] + i (its own
    chunk prefix included). No ring buffer: the engine gates chunked
    prefill to full-causal archs.
    """
    C, Sc = q.shape[1], cache_k.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    qi = offsets[:, None, None] + torch.arange(C, device=q.device)[None, :,
                                                                   None]
    kj = torch.arange(Sc, device=q.device)[None, None, :]
    mask = (kj <= qi)[:, None, :, :]           # (B, 1, C, Sc)
    return _attend_scores_softmax(q, cache_k, cache_v, mask, scale)


# ---------------------------------------------------------------------------
# Paged KV primitives (block pool)
#
# A layer's pool is (NB + 1, bs, kv, hd): NB blocks that block tables name,
# plus one trash block at index NB that no table names. A per-row block
# table (B, MB) of pool indices (-1 = unallocated) maps position p of row b
# to flat slot table[b, p // bs] * bs + p % bs. The reference drops
# out-of-range scatter indices (``mode="drop"``); here they land in the
# trash block, NB * bs being its first slot, so a dropped write needs no
# data-dependent shape and never synchronises the stream.
# ---------------------------------------------------------------------------


def gather_block_view(pool_layer, block_table, block_size: int):
    """One layer's contiguous view of the block pool: pool_layer (NB+1, bs,
    kv, hd), block_table (B, MB) -> (B, MB*bs, kv, hd). Unallocated entries
    read block 0; those positions are >= the row's length and masked."""
    B, MB = block_table.shape
    g = pool_layer[torch.clamp(block_table, min=0).long()]
    return g.reshape(B, MB * block_size, *pool_layer.shape[2:])


def flat_block_indices(block_table, lens, valid, block_size: int,
                       num_blocks: int):
    """Flat pool destinations of a (B, C) slab write starting at ``lens``.

    valid: (B, C) bool — which of the C tokens per row to write. Returns
    (B, C) int64 indices into the flattened pool; invalid positions
    (masked, past the table, or on an unallocated block) map to
    ``num_blocks * block_size``, the trash block's first slot."""
    C = valid.shape[1]
    MB = block_table.shape[1]
    pos = lens.long()[:, None] + torch.arange(C, device=valid.device)[None]
    blk = pos // block_size
    ok = valid & (blk < MB)
    pool_idx = block_table.long().gather(1, torch.clamp(blk, 0, MB - 1))
    ok &= pool_idx >= 0
    flat = pool_idx * block_size + pos % block_size
    return torch.where(ok, flat, num_blocks * block_size)


def scatter_block_kv(pool, new, flat):
    """Write new K/V entries into the block pool, in place.

    pool: (NB+1, bs, kv, hd) or (L, NB+1, bs, kv, hd), contiguous; new:
    (B, C, kv, hd) or (L, B, C, kv, hd); flat: (B, C) from
    :func:`flat_block_indices`. Valid destinations are unique (rows own
    disjoint blocks), so only the trash slot is written more than once."""
    idx = flat.reshape(-1)
    if pool.dim() == 5:
        L, NB1, bs = pool.shape[:3]
        pf = pool.view(L, NB1 * bs, *pool.shape[3:])
        pf.index_copy_(1, idx, new.reshape(L, -1, *new.shape[3:])
                       .to(pool.dtype))
    else:
        NB1, bs = pool.shape[:2]
        pf = pool.view(NB1 * bs, *pool.shape[2:])
        pf.index_copy_(0, idx, new.reshape(-1, *new.shape[2:])
                       .to(pool.dtype))
    return pool


def attend_paged(q, k_pool_layer, v_pool_layer, block_table, kv_len,
                 block_size: int):
    """Decode attention straight off one layer's block pool: the gathered
    contiguous view under the standard length-masked decode attention.
    q: (B, 1, nkv, g, hd); kv_len: (B,) valid entries."""
    gk = gather_block_view(k_pool_layer, block_table, block_size)
    gv = gather_block_view(v_pool_layer, block_table, block_size)
    return attend_decode(q, gk, gv, kv_len)


def attention_block(params, x, cfg: ModelConfig, positions, *,
                    cache_k=None, cache_v=None, kv_len=None,
                    mode: str = "train", window: Optional[int] = None,
                    qkv=None, rope_tables=None):
    """Self-attention for train/prefill ("train"), decode and "chunk"
    (chunked prefill; ``kv_len`` carries the rows' offsets before the
    chunk).

    In decode and chunk mode the cache must already hold this step's K/V;
    ``qkv``
    passes the projections the caller computed to write it, so they are
    not recomputed. Returns (out, new_k, new_v): new_k/new_v are this
    call's K/V entries (B, Sq, nkv, hd).
    """
    window = cfg.sliding_window if window is None else window
    nkv = cfg.num_kv_heads
    B, Sq, _ = x.shape
    q, k, v = qkv if qkv is not None else _project_qkv(
        params, x, cfg, positions, rope_tables)
    qg = _expand_gqa(q, nkv)
    if mode == "decode":
        assert Sq == 1
        out = attend_decode(qg, cache_k, cache_v, kv_len,
                            window=window, ring=bool(window))
    elif mode == "chunk":
        out = attend_chunk_cached(qg, cache_k, cache_v, kv_len)
    elif mode == "train":
        out = attend_full(qg, k, v, causal=True, window=window)
    else:
        raise ValueError(f"unknown attention mode {mode!r}")
    out = out.reshape(B, Sq, cfg.num_heads * cfg.resolved_head_dim)
    out = torch.matmul(out, params["w_o"]).to(x.dtype)
    return out, k, v
