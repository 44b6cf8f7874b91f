"""The dense decoder stack over a contiguous or a paged KV cache.

``apply_dense_stack(params, x, positions, cfg, cache, mode) -> (y,
cache)`` with ``mode`` "prefill", "decode" or "chunk" (chunked prefill).
Layer parameters are stacked along a leading L axis, as in the reference;
a Python loop over the layers takes the place of ``lax.scan``. A pipeline
stage runs the stack on a slice of the layers (``stage_bounds``,
``slice_stage_params``, ``slice_stage_cache``): the slices are views, so
a stage writes its K/V into the full cache's tensors.

The contiguous cache is a dict ``{"len": (B,) int32, "pos": () int32,
"k"/"v": (L, B, S_c, nkv, hd)}``; sliding-window archs keep a ring buffer
(slot = pos % S_c). A paged cache (``engine/paged_cache.py``) holds
``"k_pool"/"v_pool": (L, NB+1, bs, nkv, hd)`` and a ``"block_table"``
instead, and serves decode and chunk mode: each layer gathers its
contiguous block view, runs the same cached attention over it, and
scatters the new entries into the pool. Unlike the reference's immutable
arrays, K/V entries are written IN PLACE (the cache is the largest state
the engine holds); ``len``/``pos`` are replaced, not mutated.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.models.attention import (_project_qkv, attention_block,
                                         flat_block_indices,
                                         gather_block_view, scatter_block_kv)
from repro_torch.models.layers import (apply_mlp, dense_init, rms_norm,
                                      rope_tables, torch_dtype)


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP 'Modules to port' item 4)")


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------


def cache_len_for(cfg: ModelConfig, seq_len: int,
                  window: Optional[int] = None) -> int:
    w = cfg.sliding_window if window is None else window
    return min(seq_len, w) if w else seq_len


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               window: Optional[int] = None, dtype=None, device="cpu"):
    """The decode/prefill cache of a dense decoder. ``seq_len`` is the
    maximum context length; sliding-window archs allocate only ``window``
    slots (ring buffer)."""
    if cfg.family != "dense":
        raise _unported(f"the {cfg.family!r} family's cache")
    dtype = dtype or torch_dtype(cfg.dtype)
    Sc = cache_len_for(cfg, seq_len, window)
    shape = (cfg.num_layers, batch, Sc, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def _write_kv(cache_k_l, cache_v_l, k, v, lens, mode: str,
              mask=None) -> None:
    """Write new K/V into one layer's cache, in place. Handles ring buffers.

    cache_k_l: (B, Sc, nkv, hd); k: (B, S_new, nkv, hd); lens: (B,) current
    per-sequence lengths (write positions). Prefill assumes fresh rows:
    entries land at slots 0..S_new-1, or, when S_new >= Sc, the last Sc
    entries rotated into ring order (the reference's ``jnp.roll``).
    Mode "chunk": an S_new-wide slab at each row's offset, only for rows in
    ``mask`` (B,); other rows keep their entries.
    """
    Sc = cache_k_l.shape[1]
    S_new = k.shape[1]
    if mode == "decode":            # one token per row at slot lens[b] % Sc
        rows = torch.arange(k.shape[0], device=k.device)
        slot = lens.long() % Sc     # always in range: nothing to clamp
        cache_k_l[rows, slot] = k[:, 0]
        cache_v_l[rows, slot] = v[:, 0]
    elif mode == "prefill":
        if S_new >= Sc:
            s0 = S_new % Sc
            cache_k_l.copy_(torch.roll(k[:, -Sc:], s0, dims=1))
            cache_v_l.copy_(torch.roll(v[:, -Sc:], s0, dims=1))
        else:
            # the reference's dynamic_update_slice at 0 (never clamped:
            # S_new < Sc)
            cache_k_l[:, :S_new] = k
            cache_v_l[:, :S_new] = v
    elif mode == "chunk":
        # the reference's dynamic_update_slice clamps the start to Sc -
        # S_new; torch indexing does not, so clamp here. The (B, C) program
        # computes garbage K/V for rows outside the mask (co-resident
        # decode rows): a masked read-modify-write keeps their slab.
        B = k.shape[0]
        mask = lens >= 0 if mask is None else mask
        start = torch.clamp(lens.long(), 0, Sc - S_new)
        idx = start[:, None] + torch.arange(S_new, device=k.device)[None]
        rows = torch.arange(B, device=k.device)[:, None]
        keep = mask[:, None, None, None]
        cache_k_l[rows, idx] = torch.where(keep, k.to(cache_k_l.dtype),
                                           cache_k_l[rows, idx])
        cache_v_l[rows, idx] = torch.where(keep, v.to(cache_v_l.dtype),
                                           cache_v_l[rows, idx])
    else:
        raise ValueError(f"unknown KV write mode {mode!r}")


def stage_bounds(num_layers: int, num_stages: int):
    """Balanced contiguous layer split for pipeline parallelism: stage s
    owns layers [lo, hi); earlier stages absorb the remainder, so no stage
    is more than one layer heavier."""
    assert 1 <= num_stages <= num_layers, (num_stages, num_layers)
    base, rem = divmod(num_layers, num_stages)
    bounds, lo = [], 0
    for s in range(num_stages):
        hi = lo + base + (1 if s < rem else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def _slice_layers(tree, lo: int, hi: int):
    if isinstance(tree, dict):
        return {k: _slice_layers(v, lo, hi) for k, v in tree.items()}
    return tree[lo:hi]


def slice_stage_params(stack_params: dict, lo: int, hi: int, *, last: bool):
    """A stage's slice of a dense stack's parameters: every stacked
    per-layer leaf keeps rows [lo, hi) (a view); ``final_ln`` ships only
    with the last stage (it runs after the full depth). The stages run one
    after another compose to the full stack exactly."""
    out = {k: _slice_layers(v, lo, hi)
           for k, v in stack_params.items() if k != "final_ln"}
    if last:
        out["final_ln"] = stack_params["final_ln"]
    return out


def slice_stage_cache(cache: dict, lo: int, hi: int):
    """A stage's slice of a cache: per-layer leaves (k/v slabs or paged
    pools, leading L axis) keep layers [lo, hi) as views of the full
    cache's tensors; per-sequence leaves (len/pos/block_table) pass
    through whole."""
    out = dict(cache)
    for k in ("k", "v", "k_pool", "v_pool"):
        if k in cache:
            out[k] = cache[k][lo:hi]
    return out


# ---------------------------------------------------------------------------
# Dense decoder stack
# ---------------------------------------------------------------------------


def init_dense_stack(gen: torch.Generator, cfg: ModelConfig, device):
    """Seeded weights of the dense stack in the reference's layout: every
    per-layer leaf stacked on a leading L axis, weights (in, out)."""
    if cfg.family != "dense":
        raise _unported(f"the {cfg.family!r} family's stack")
    dt = torch_dtype(cfg.dtype)
    L, d, f = cfg.num_layers, cfg.d_model, cfg.d_ff
    hd, nh, nkv = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    mk = lambda *shape: dense_init(gen, shape, dt, device)
    ones = lambda *shape: torch.ones(shape, dtype=dt, device=device)
    attn = {"w_q": mk(L, d, nh * hd), "w_k": mk(L, d, nkv * hd),
            "w_v": mk(L, d, nkv * hd), "w_o": mk(L, nh * hd, d)}
    if cfg.qk_norm:
        attn["q_norm"] = ones(L, hd)
        attn["k_norm"] = ones(L, hd)
    mlp = {"w_up": mk(L, d, f), "w_down": mk(L, f, d)}
    if cfg.act == "silu":
        mlp["w_gate"] = mk(L, d, f)
    return {"ln1": ones(L, d), "ln2": ones(L, d), "attn": attn, "mlp": mlp,
            "final_ln": ones(d)}


def _layer(tree, i: int):
    """Layer ``i``'s slice of a stacked parameter tree."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def apply_dense_stack(params, x, positions, cfg: ModelConfig, cache,
                      mode: str, window: Optional[int] = None,
                      chunk_mask=None, chunk_counts=None,
                      final_norm: bool = True):
    """x: (B, S, d). Returns (y, cache), y final-normed unless
    ``final_norm=False``: a pipeline stage that is not the last hands its
    residual stream to the next stage raw (its ``params`` then need not
    carry ``final_ln``). The layers are those ``params`` carry, so a
    stage's slice runs its own layers.

    ``chunk_mask`` (B,) selects the rows of a "chunk" call whose K/V are
    written; ``chunk_counts`` (B,) gives each row's valid tokens in the
    slab (the paged pool scatter needs them; the contiguous slab write
    does not)."""
    if cfg.family != "dense":
        raise _unported(f"the {cfg.family!r} family's stack")
    eps = cfg.rmsnorm_eps
    win = cfg.sliding_window if window is None else window
    lens0 = cache["len"]
    # valid entries after a decode write; a chunk attends from its offsets
    kv_len = lens0 + 1 if mode == "decode" else lens0
    paged = "k_pool" in cache
    if paged:
        assert mode in ("decode", "chunk"), \
            "a paged cache serves decode and chunk mode only (prefill rows " \
            "are scattered in by the engine)"
        bt = cache["block_table"]
        blk = cache["k_pool"].shape[2]
        nblocks = cache["k_pool"].shape[1] - 1        # the last is trash
        B, C = x.shape[0], x.shape[1]
        if mode == "decode":
            pool_valid = torch.ones((B, C), dtype=torch.bool, device=x.device)
        else:
            counts = chunk_counts if chunk_counts is not None else \
                torch.full((B,), C, dtype=torch.int32, device=x.device)
            pool_valid = torch.arange(C, device=x.device)[None, :] < \
                counts[:, None]
            if chunk_mask is not None:
                pool_valid &= chunk_mask[:, None]
        # one (B, C) destination map shared by every layer's pool scatter
        pool_flat = flat_block_indices(bt, lens0, pool_valid, blk, nblocks)
    layers = {k: v for k, v in params.items() if k != "final_ln"}
    rt = rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta) \
        if cfg.rope_theta > 0 else None
    for i in range(params["ln1"].shape[0]):
        lp = _layer(layers, i)
        h = rms_norm(x, lp["ln1"], eps)
        if mode in ("decode", "chunk"):
            if paged:
                # this layer's contiguous view of the pool: a per-step
                # temporary the cached attention runs on unchanged
                ck = gather_block_view(cache["k_pool"][i], bt, blk)
                cv = gather_block_view(cache["v_pool"][i], bt, blk)
            else:
                ck, cv = cache["k"][i], cache["v"][i]
            # write first so each token attends to itself
            qkv = _project_qkv(lp["attn"], h, cfg, positions, rt)
            _write_kv(ck, cv, qkv[1], qkv[2], lens0, mode, chunk_mask)
            attn_out, _, _ = attention_block(
                lp["attn"], h, cfg, positions, cache_k=ck, cache_v=cv,
                kv_len=kv_len, mode=mode, window=win, qkv=qkv)
            if paged:
                # persist only the new entries
                scatter_block_kv(cache["k_pool"][i], qkv[1], pool_flat)
                scatter_block_kv(cache["v_pool"][i], qkv[2], pool_flat)
        elif mode == "prefill":
            attn_out, k, v = attention_block(lp["attn"], h, cfg, positions,
                                             mode="train", window=win,
                                             rope_tables=rt)
            _write_kv(cache["k"][i], cache["v"][i], k, v, lens0, "prefill")
        else:
            raise ValueError(f"unknown stack mode {mode!r}")
        x = x + attn_out
        x = x + apply_mlp(lp["mlp"], rms_norm(x, lp["ln2"], eps), cfg.act)
    cache = dict(cache)
    S_new = positions.shape[-1]
    cache["len"] = cache["len"] + S_new
    cache["pos"] = cache["pos"] + S_new
    if final_norm:
        x = rms_norm(x, params["final_ln"], eps)
    return x, cache
