"""The dense decoder stack over a contiguous KV cache.

``apply_dense_stack(params, x, positions, cfg, cache, mode) -> (y,
cache)`` with ``mode`` "prefill" or "decode". Layer
parameters are stacked along a leading L axis, as in the reference; a
Python loop over the layers takes the place of ``lax.scan``.

The cache is a dict ``{"len": (B,) int32, "pos": () int32, "k"/"v":
(L, B, S_c, nkv, hd)}``; sliding-window archs keep a ring buffer (slot =
pos % S_c). Unlike the reference's immutable arrays, K/V entries are
written into the cache tensors IN PLACE (it is the largest state the
engine holds); ``len``/``pos`` are replaced, not mutated.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.models.attention import _project_qkv, attention_block
from repro_torch.models.layers import (apply_mlp, dense_init, rms_norm,
                                      rope_tables, torch_dtype)


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP 'Modules to port' item 11)")


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


def _write_kv(cache_k_l, cache_v_l, k, v, lens, mode: str) -> None:
    """Write new K/V into one layer's cache, in place. Handles ring buffers.

    cache_k_l: (B, Sc, nkv, hd); k: (B, S_new, nkv, hd); lens: (B,) current
    per-sequence lengths (write positions). Prefill assumes fresh rows:
    entries land at slots 0..S_new-1, or, when S_new >= Sc, the last Sc
    entries rotated into ring order (the reference's ``jnp.roll``).
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
    else:
        raise ValueError(f"KV write mode {mode!r} is not ported "
                         "(ROADMAP 'Modules to port' item 6)")


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
                      mode: str, window: Optional[int] = None):
    """x: (B, S, d). Returns (final-normed y, cache)."""
    if cfg.family != "dense":
        raise _unported(f"the {cfg.family!r} family's stack")
    eps = cfg.rmsnorm_eps
    win = cfg.sliding_window if window is None else window
    lens0 = cache["len"]
    kv_len = lens0 + 1 if mode == "decode" else None
    layers = {k: v for k, v in params.items() if k != "final_ln"}
    rt = rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta) \
        if cfg.rope_theta > 0 else None
    for i in range(cfg.num_layers):
        lp = _layer(layers, i)
        h = rms_norm(x, lp["ln1"], eps)
        if mode == "decode":
            # write first so the current token attends to itself
            qkv = _project_qkv(lp["attn"], h, cfg, positions, rt)
            ck, cv = cache["k"][i], cache["v"][i]
            _write_kv(ck, cv, qkv[1], qkv[2], lens0, "decode")
            attn_out, _, _ = attention_block(
                lp["attn"], h, cfg, positions, cache_k=ck, cache_v=cv,
                kv_len=kv_len, mode="decode", window=win, qkv=qkv)
        elif mode == "prefill":
            attn_out, k, v = attention_block(lp["attn"], h, cfg, positions,
                                             mode="train", window=win,
                                             rope_tables=rt)
            _write_kv(cache["k"][i], cache["v"][i], k, v, lens0, "prefill")
        else:
            raise ValueError(f"stack mode {mode!r} is not ported "
                             "(ROADMAP 'Modules to port' item 6)")
        x = x + attn_out
        x = x + apply_mlp(lp["mlp"], rms_norm(x, lp["ln2"], eps), cfg.act)
    cache = dict(cache)
    S_new = positions.shape[-1]
    cache["len"] = cache["len"] + S_new
    cache["pos"] = cache["pos"] + S_new
    return rms_norm(x, params["final_ln"], eps), cache
