"""Attention: GQA with RoPE, optional qk-norm and sliding window.

Written as the einsum/softmax it is in the reference (scores and the
weighted sum accumulate in float32), not as a fused library attention.

* ``attend_full``   — direct masked softmax (train/prefill below
  ``chunk_threshold`` tokens, and the decoder's cross attention).
* ``attend_chunked`` — blocked attention with a running max and sum
  (train/prefill from ``chunk_threshold`` = 4096 tokens on), so the
  scores of one block pair are live at a time, not all S² of them.
* ``attend_decode`` — one query token against a KV cache with a length
  mask; with ``ring=True`` the cache is a sliding-window ring buffer.
* ``attend_chunk_cached`` — C prompt tokens per row at per-row offsets
  against the cache (chunked prefill).

Under a mesh (``models/dist.py``) the projections are column-parallel:
``w_q``/``w_k``/``w_v`` blocks give the rank's columns, which one
all-gather over the model axes makes whole heads again (a block may end in
the middle of a head: smollm's 15 heads of 64 at t = 4); qk-norm and RoPE
run on whole heads. ``w_o`` is row-parallel on the rank's columns of the
attention output, with one ``psum``. The cache's sequence dimension is
split over the model axes (``launch/sharding.cache_shardings``): a decode
step attends over the rank's slots and the ranks' partial softmaxes merge
(:func:`attend_decode_block`); prefill attends over the prompt's own K/V,
which the gather leaves whole on every rank, and each rank writes only its
slots.

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
from repro_torch.models import dist
from repro_torch.models.layers import (apply_rope, dense_init, matmul,
                                      rms_norm, row_parallel, torch_dtype)

NEG_INF = -1e30


def init_attention(gen: torch.Generator, cfg: ModelConfig, device,
                   stacked: int = 0):
    """Seeded attention weights in the reference's layout (``(in, out)``,
    a leading L axis when ``stacked``)."""
    dt = torch_dtype(cfg.dtype)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nh, nkv = cfg.num_heads, cfg.num_kv_heads
    pre = (stacked,) if stacked else ()
    mk = lambda i, o: dense_init(gen, pre + (i, o), dt, device)
    p = {"w_q": mk(d, nh * hd), "w_k": mk(d, nkv * hd),
         "w_v": mk(d, nkv * hd), "w_o": mk(nh * hd, d)}
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(pre + (hd,), dtype=dt, device=device)
        p["k_norm"] = torch.ones(pre + (hd,), dtype=dt, device=device)
    return p


def _project_qkv(params, x, cfg: ModelConfig, positions, rope_tables=None,
                 *, rope: bool = True):
    """Project to q/k/v, apply qk-norm + RoPE (unless ``rope=False``, as
    the encoder asks). Returns (q, k, v) with shapes (B, S, nh, hd), (B,
    S, nkv, hd), (B, S, nkv, hd). ``rope_tables``: the forward's shared
    cos/sin, if already made."""
    hd = cfg.resolved_head_dim
    nh, nkv = cfg.num_heads, cfg.num_kv_heads
    B, S = x.shape[0], x.shape[1]
    q, k, v = _whole_cols(
        [matmul(x, params[w]) for w in ("w_q", "w_k", "w_v")],
        [nh * hd, nkv * hd, nkv * hd])
    q = q.reshape(B, S, nh, hd)
    k = k.reshape(B, S, nkv, hd)
    v = v.reshape(B, S, nkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.rmsnorm_eps)
        k = rms_norm(k, params["k_norm"], cfg.rmsnorm_eps)
    if rope and cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta, rope_tables)
        k = apply_rope(k, positions, cfg.rope_theta, rope_tables)
    return q, k, v


def _whole_cols(outs, widths):
    """Column-parallel products made whole: the outputs whose width is a
    block of ``widths`` are gathered over the model axes in one call."""
    split = [i for i, (o, w) in enumerate(zip(outs, widths))
             if dist.split_block(o.shape[-1], w)]
    if split:
        whole = dist.gather_cols([outs[i] for i in split])
        outs = list(outs)
        for i, o in zip(split, whole):
            outs[i] = o
    return outs


def _out_proj(out, w_o, dtype):
    """``out @ w_o`` rounded to ``dtype``; ``out`` is whole, and a block
    of ``w_o``'s rows makes it row-parallel on the rank's columns."""
    n = w_o.shape[-2]
    if dist.split_block(n, out.shape[-1]):
        return row_parallel(dist.model_block(out, -1, n), w_o, dtype)
    return torch.matmul(out, w_o).to(dtype)


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


def _scale(q, scale: Optional[float]) -> float:
    """The softmax's scale: 1/sqrt(head_dim) unless the model sets one
    (Granite's ``attention_multiplier``)."""
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale


def attend_full(q, k, v, *, causal: bool, window: int, q_offset: int = 0,
                scale: Optional[float] = None):
    """Direct attention. q: (B,Sq,nkv,g,hd); k,v: (B,Skv,nkv,hd); query i
    sits at position ``q_offset + i``."""
    B, Sq = q.shape[0], q.shape[1]
    Skv = k.shape[1]
    scale = _scale(q, scale)
    qi = torch.arange(Sq, device=q.device)[:, None] + q_offset
    kj = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kj <= qi
    if window:
        mask &= kj > qi - window
    mask = mask[None].expand(B, Sq, Skv)
    return _attend_scores_softmax(q, k, v, mask[:, None], scale)


def attend_chunked(q, k, v, *, causal: bool, window: int,
                   chunk_q: int = 512, chunk_k: int = 512,
                   scale: Optional[float] = None):
    """Blocked attention with a running max ``m``, sum ``l`` and
    accumulator, all float32, over blocks of ``chunk_q`` queries and
    ``chunk_k`` keys; shapes as in :func:`attend_full`.

    Lengths that are no multiple of the block are padded at the end: the
    causal mask hides pad keys from real queries and pad query rows are
    sliced off. A block pair that the mask hides entirely is skipped: the
    reference computes it, but there every score is -1e30, so it adds
    exactly 0 after a visible block and is scaled by exactly 0 before
    one; skipping it changes no bit."""
    Sq_real, Skv_real = q.shape[1], k.shape[1]
    pq, pk = (-Sq_real) % chunk_q, (-Skv_real) % chunk_k
    if pq or pk:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, 0, 0, pq))
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pk))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pk))
    B, Sq, nkv, g, hd = q.shape
    nq, nk = Sq // chunk_q, k.shape[1] // chunk_k
    scale = _scale(q, scale)
    dev = q.device
    ar_q = torch.arange(chunk_q, device=dev)[:, None]
    ar_k = torch.arange(chunk_k, device=dev)[None, :]
    outs = []
    for i in range(nq):
        q_blk = q[:, i * chunk_q:(i + 1) * chunk_q].float()
        q_lo, q_hi = i * chunk_q, (i + 1) * chunk_q - 1
        m = torch.full((B, nkv, g, chunk_q), NEG_INF, device=dev)
        l = torch.zeros((B, nkv, g, chunk_q), device=dev)
        acc = torch.zeros((B, nkv, g, chunk_q, hd), device=dev)
        for j in range(nk):
            k_lo, k_hi = j * chunk_k, (j + 1) * chunk_k - 1
            if (causal and k_lo > q_hi) or (window and k_hi <= q_lo - window):
                continue
            k_blk = k[:, k_lo:k_hi + 1].float()
            v_blk = v[:, k_lo:k_hi + 1].float()
            s = torch.einsum("bqngh,bknh->bngqk", q_blk, k_blk) * scale
            qpos, kpos = q_lo + ar_q, k_lo + ar_k
            msk = torch.ones((chunk_q, chunk_k), dtype=torch.bool,
                             device=dev)
            if causal:
                msk &= kpos <= qpos
            if window:
                msk &= kpos > qpos - window
            s = torch.where(msk, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bngqk,bknh->bngqh", p, v_blk)
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4))    # (B, chunk_q, nkv, g, hd)
    return torch.cat(outs, dim=1)[:, :Sq_real].to(v.dtype)


def attend_decode(q, cache_k, cache_v, kv_len, *, window: int = 0,
                  ring: bool = False, scale: Optional[float] = None):
    """Single-step decode attention.

    q: (B, 1, nkv, g, hd); cache_k/v: (B, S_cache, nkv, hd);
    kv_len: (B,) number of valid entries. With ``ring=True`` the cache is a
    ring buffer (sliding window) and every slot < min(len, S_cache) is valid.
    """
    S = cache_k.shape[1]
    scale = _scale(q, scale)
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


def attend_decode_block(q, k_blk, v_blk, valid,
                        scale: Optional[float] = None):
    """Single-token attention over the rank's block of the keys, merged
    across the model group: each rank's partial softmax — its running max
    m, sum l and weighted values — is all-gathered in one call, and every
    rank merges the t partials in rank order (so all hold the same
    result). q: (B, 1, nkv, g, hd); k_blk/v_blk: (B, n, nkv, hd); valid:
    (B, n) the keys that take part. A rank whose block holds no valid key
    gives m = -1e30 (masked scores are finite), l = 0 and no values, and
    weighs exp(-1e30 - M) = 0 in the merge. Returns (B, 1, nkv, g, hd)."""
    scale = _scale(q, scale)
    s = torch.einsum("bngh,bknh->bngk", q[:, 0].float(),
                     k_blk.float()) * scale
    mask = valid[:, None, None, :]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    acc = torch.einsum("bngk,bknh->bngh", p, v_blk.float())
    part = torch.cat([m[..., None], p.sum(-1)[..., None], acc], -1)
    parts = dist.all_gather(part, dist.get_ctx().model_axes, dim=0)
    w = torch.exp(parts[..., 0] - parts[..., 0].amax(0))      # (t, B, n, g)
    l = (parts[..., 1] * w).sum(0)
    acc = (parts[..., 2:] * w[..., None]).sum(0)
    return (acc / l[..., None])[:, None].to(v_blk.dtype)


def decode_valid(kv_len, n: int, lo: int, S: int, *, window: int = 0,
                 ring: bool = False):
    """(B, n) the valid slots lo..lo+n-1 of a cache of S slots, by
    :func:`attend_decode`'s rule."""
    kj = lo + torch.arange(n, device=kv_len.device)[None, :]
    if ring:
        return kj < torch.clamp(kv_len, max=S)[:, None]
    valid = kj < kv_len[:, None]
    if window:
        valid &= kj >= (kv_len[:, None] - window)
    return valid


def attend_chunk_cached(q, cache_k, cache_v, offsets,
                        scale: Optional[float] = None):
    """Continue-prefill attention: C query tokens per row at per-row offsets
    against the (already written) KV cache.

    q: (B, C, nkv, g, hd); cache_k/v: (B, Sc, nkv, hd); offsets: (B,) valid
    cache entries BEFORE this chunk. Query i of row b sits at position
    offsets[b] + i and attends to cache slots <= offsets[b] + i (its own
    chunk prefix included). No ring buffer: the engine gates chunked
    prefill to full-causal archs.
    """
    C, Sc = q.shape[1], cache_k.shape[1]
    scale = _scale(q, scale)
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
                    qkv=None, rope_tables=None, chunk_threshold: int = 4096,
                    kv_span=None, scale: Optional[float] = None):
    """Self-attention for train/prefill ("train"), decode and "chunk"
    (chunked prefill; ``kv_len`` carries the rows' offsets before the
    chunk). Train/prefill attends with :func:`attend_chunked` from
    ``chunk_threshold`` tokens on, with :func:`attend_full` below.

    In decode and chunk mode the cache must already hold this step's K/V;
    ``qkv``
    passes the projections the caller computed to write it, so they are
    not recomputed. ``kv_span`` = (lo, S): the cache holds this rank's
    slots lo.. of a cache of S slots split over the model axes (decode
    only); None: the whole cache. ``scale``: the softmax's, None for
    1/sqrt(head_dim). Returns (out, new_k, new_v):
    new_k/new_v are this call's K/V entries (B, Sq, nkv, hd).
    """
    window = cfg.sliding_window if window is None else window
    nkv = cfg.num_kv_heads
    B, Sq, _ = x.shape
    q, k, v = qkv if qkv is not None else _project_qkv(
        params, x, cfg, positions, rope_tables)
    qg = _expand_gqa(q, nkv)
    if mode == "decode" and kv_span is not None:
        assert Sq == 1
        lo, S = kv_span
        valid = decode_valid(kv_len, cache_k.shape[1], lo, S, window=window,
                             ring=bool(window))
        out = attend_decode_block(qg, cache_k, cache_v, valid, scale=scale)
    elif mode == "decode":
        assert Sq == 1
        out = attend_decode(qg, cache_k, cache_v, kv_len,
                            window=window, ring=bool(window), scale=scale)
    elif mode == "chunk":
        out = attend_chunk_cached(qg, cache_k, cache_v, kv_len, scale=scale)
    elif mode == "train":
        attend = attend_chunked if Sq >= chunk_threshold else attend_full
        out = attend(qg, k, v, causal=True, window=window, scale=scale)
    else:
        raise ValueError(f"unknown attention mode {mode!r}")
    out = out.reshape(B, Sq, cfg.num_heads * cfg.resolved_head_dim)
    return _out_proj(out, params["w_o"], x.dtype), k, v


def cross_attention_block(params, x, enc_kv, cfg: ModelConfig):
    """Cross-attention of the decoder (whisper) over the encoder's output:
    ``enc_kv`` = (k, v) from :func:`project_enc_kv`, each (B, S_enc, nkv,
    hd); every query sees every frame. Under a mesh ``enc_kv`` may be the
    rank's block of the frames (the decode cache's): one query then
    attends over it and the ranks' partials merge."""
    B, Sq, _ = x.shape
    hd = cfg.resolved_head_dim
    q, = _whole_cols([matmul(x, params["w_q"])], [cfg.num_heads * hd])
    q = _expand_gqa(q.reshape(B, Sq, cfg.num_heads, hd), cfg.num_kv_heads)
    k, v = enc_kv
    if dist.split_block(k.shape[1], cfg.encoder.num_frames):
        assert Sq == 1, "a block of the frames serves one decode query"
        valid = torch.ones(k.shape[:2], dtype=torch.bool, device=k.device)
        out = attend_decode_block(q, k, v, valid)
    else:
        out = attend_full(q, k, v, causal=False, window=0)
    out = out.reshape(B, Sq, cfg.num_heads * hd)
    return _out_proj(out, params["w_o"], x.dtype)


def project_enc_kv(params, enc_out, cfg: ModelConfig):
    """The encoder output (B, S, d) projected to the decoder's cross
    K/V, each (B, S, nkv, hd) (whole heads under a mesh too)."""
    B, S, _ = enc_out.shape
    w = cfg.num_kv_heads * cfg.resolved_head_dim
    shape = (B, S, cfg.num_kv_heads, cfg.resolved_head_dim)
    k, v = _whole_cols([matmul(enc_out, params["w_k"]),
                        matmul(enc_out, params["w_v"])], [w, w])
    return k.reshape(shape), v.reshape(shape)
