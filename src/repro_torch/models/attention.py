"""Attention: GQA with RoPE, optional qk-norm and sliding window.

Written as the einsum/softmax it is in the reference (scores and the
weighted sum accumulate in float32), not as a fused library attention.

* ``attend_full``   — direct masked softmax (train/prefill).
* ``attend_decode`` — one query token against a KV cache with a length
  mask; with ``ring=True`` the cache is a sliding-window ring buffer.

KV caches are per-layer ``(B, S_cache, kv_heads, head_dim)``.
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


def attention_block(params, x, cfg: ModelConfig, positions, *,
                    cache_k=None, cache_v=None, kv_len=None,
                    mode: str = "train", window: Optional[int] = None,
                    qkv=None, rope_tables=None):
    """Self-attention for train/prefill ("train") and decode.

    In decode mode the cache must already hold this step's K/V; ``qkv``
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
    elif mode == "train":
        out = attend_full(qg, k, v, causal=True, window=window)
    else:
        raise ValueError(f"attention mode {mode!r} is not ported "
                         "(ROADMAP 'Modules to port' item 6)")
    out = out.reshape(B, Sq, cfg.num_heads * cfg.resolved_head_dim)
    out = torch.matmul(out, params["w_o"]).to(x.dtype)
    return out, k, v
