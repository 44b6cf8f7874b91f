"""Decoder stacks of every family, and the whisper encoder.

``apply_<family>_stack(params, x, positions, cfg, cache, mode) -> (y,
cache, aux)`` with ``mode`` "train" (no cache), "prefill" or "decode",
and "chunk" (chunked prefill) for the dense/MoE stack; ``aux`` is the
MoE load-balance loss summed over the layers (weighed by
``aux_loss_weight`` in training, 0 otherwise). Layer parameters are
stacked along a leading L axis, as in the reference; a Python loop over
the layers takes the place of ``lax.scan``. With ``remat=True`` a train
forward checkpoints each layer (the reference's ``jax.checkpoint`` of the
scan body): the backward recomputes the layer instead of keeping its
activations.

* ``dense``/``moe``/``vlm``/``audio``: :func:`apply_dense_stack` over a
  contiguous or a paged KV cache, an MLP or a MoE FFN a layer; the audio
  family (whisper) uses LayerNorm with a zero bias and a cross attention
  over the encoder's output (:func:`apply_encoder`), whose K/V prefill
  stores in the cache's ``cross_k``/``cross_v`` for decode. A pipeline
  stage runs it on a slice of the layers (``stage_bounds``,
  ``slice_stage_params``, ``slice_stage_cache``): the slices are views,
  so a stage writes its K/V into the full cache's tensors.
* ``ssm`` (RWKV-6): :func:`apply_rwkv_stack`, attention-free.
* ``hybrid`` (Zamba2): :func:`apply_zamba_stack`, Mamba2 layers with one
  weight-shared attention block before every group of ``attn_every``.
* ``hybrid_moe`` (Granite 4.0-H, ``config.HybridMoEConfig``):
  :func:`apply_typed_stack`, a layer's own mixer by ``layer_types``
  (Mamba2 or NoPE attention), a MoE after every one.

The contiguous cache is a dict ``{"len": (B,) int32, "pos": () int32}``
plus the family's leaves (:func:`init_cache`), every one (L|G, B, ...)
with the batch on axis 1; sliding-window archs keep a ring buffer (slot
= pos % S_c). A paged cache (``engine/paged_cache.py``) holds
``"k_pool"/"v_pool": (L, NB+1, bs, nkv, hd)`` and a ``"block_table"``
instead, and serves decode and chunk mode: each layer gathers its
contiguous block view, runs the same cached attention over it, and
scatters the new entries into the pool. Unlike the reference's immutable
arrays, K/V entries and recurrent states are written IN PLACE (the cache
is the largest state the engine holds); ``len``/``pos`` are replaced,
not mutated.

Under a mesh whose model axes have size t > 1 (``models/dist.py``) a
rank's cache holds its block (:func:`init_cache`): the K/V sequence
dimension is split over the model axes where t divides it
(``launch/sharding.cache_shardings``; the forward reads a block from a
length t divides, :func:`kv_span`), whisper's cross K/V by frames, RWKV's
token shifts and Zamba2's conv carry by channels, RWKV's WKV state by the
heads of the rank's time mix (by value columns where its block ends
inside a head). A step gathers the carried channels once
(one all-gather of every layer's) and each layer writes back its block.
Paged caches and chunked prefill under tensor parallelism are refused:
the reference has no engine that drives a mesh (ROADMAP, "Beyond the
reference").
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.models import dist
from repro_torch.models.attention import (_expand_gqa, _out_proj,
                                         _project_qkv,
                                         attend_full, attention_block,
                                         cross_attention_block,
                                         flat_block_indices,
                                         gather_block_view, init_attention,
                                         project_enc_kv, scatter_block_kv)
from repro_torch.models.layers import (apply_mlp, dense_init, init_mlp,
                                      layer_norm, rms_norm, rope_tables,
                                      torch_dtype)
from repro_torch.models.moe import apply_moe, init_moe
from repro_torch.models.ssm import (init_mamba, init_rwkv, mamba_dims,
                                    mamba_seq, mamba_xbc_seq,
                                    rwkv_channel_mix_seq, rwkv_state_shape,
                                    rwkv_time_mix_seq)
from repro_torch.obs.tracer import current as current_tracer


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------


def cache_len_for(cfg: ModelConfig, seq_len: int,
                  window: Optional[int] = None) -> int:
    w = cfg.sliding_window if window is None else window
    return min(seq_len, w) if w else seq_len


def kv_span(n: int):
    """(lo, S) of a K/V cache leaf whose sequence dimension holds ``n``
    slots on this rank: its block lo..lo+n-1 of S = t·n slots where the
    model axes' size t > 1 divides n, None (whole) otherwise. The rule
    reads the block's own length, so :func:`init_cache` splits a cache of
    S slots only where t divides S/t as well."""
    t = dist.tp_size()
    if t > 1 and n % t == 0:
        return dist.tp_rank() * n, t * n
    return None


def kv_slots(S: int) -> int:
    """The slots a rank holds of a K/V cache of S: S/t where t divides it
    (``cache_shardings``), S otherwise."""
    t = dist.tp_size()
    if t <= 1 or S % t:
        return S
    if (S // t) % t:
        raise ValueError(
            f"a K/V cache of {S} slots splits over {t} model ranks into "
            f"blocks of {S // t}, which {t} does not divide: the forward "
            "could not tell such a block from a whole cache")
    return S // t


def _cut(n: int) -> int:
    """A dimension of n the spec splits over the model axes: n/t where t
    divides it, n otherwise."""
    t = dist.tp_size()
    return n // t if t > 1 and n % t == 0 else n


def rwkv_state_local(cfg: ModelConfig):
    """(heads, key, value) of this rank's RWKV-6 WKV state
    (``ssm.rwkv_state_shape`` of the time mix's column block: d/t where t
    divides d)."""
    return rwkv_state_shape(_cut(cfg.d_model), cfg.d_model,
                            cfg.ssm.rwkv_head_size)


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               window: Optional[int] = None, dtype=None, device="cpu"):
    """The decode/prefill cache of ``cfg``'s family. ``seq_len`` is the
    maximum context length; sliding-window archs allocate only ``window``
    slots (ring buffer). RWKV keeps its f32 wkv state and the two token
    shifts; Zamba2 its f32 SSM state, the conv carry and the K/V of its
    G = ceil(L / attn_every) shared-attention sites, over a window of
    4096 unless the arch or the caller sets one. A typed stack
    (``hybrid_moe``) keeps two kinds of state side by side: the K/V of
    its A attention layers (A, B, S, nkv, hd), and the conv carry (M, B,
    K-1, channels) and f32 SSM state (M, B, H, hd, N) of its M Mamba2
    layers. An encoder-decoder (whisper) adds the cross K/V of its
    ``num_frames`` encoder frames.

    Under a mesh the cache is this rank's block of ``batch`` rows (the
    rows are the caller's): the split dimensions of the module docstring
    cut to 1/t."""
    dtype = dtype or torch_dtype(cfg.dtype)
    hd, nkv, d, L = (cfg.resolved_head_dim, cfg.num_kv_heads, cfg.d_model,
                     cfg.num_layers)
    zeros = lambda *shape, dt=dtype: torch.zeros(shape, dtype=dt,
                                                 device=device)
    cache = {"len": zeros(batch, dt=torch.int32),
             "pos": zeros(dt=torch.int32)}
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        Sc = kv_slots(cache_len_for(cfg, seq_len, window))
        cache["k"] = zeros(L, batch, Sc, nkv, hd)
        cache["v"] = zeros(L, batch, Sc, nkv, hd)
        if cfg.is_encdec:
            Se = _cut(cfg.encoder.num_frames)
            cache["cross_k"] = zeros(L, batch, Se, nkv, hd)
            cache["cross_v"] = zeros(L, batch, Se, nkv, hd)
    elif cfg.family == "ssm":        # rwkv6
        cache["ssm"] = zeros(L, batch, *rwkv_state_local(cfg),
                             dt=torch.float32)
        cache["x_last_t"] = zeros(L, batch, _cut(d))
        cache["x_last_c"] = zeros(L, batch, _cut(d))
    elif cfg.family == "hybrid":     # zamba2: mamba states + shared-attn kv
        inner, nheads, headdim, N = mamba_dims(cfg)
        G = -(-L // cfg.hybrid.attn_every)
        Sc = kv_slots(cache_len_for(cfg, seq_len,
                                     window or cfg.sliding_window or 4096))
        ssm = [nheads, headdim, N]
        if dist.get_ctx().active and dist.get_ctx().batch_axes is None:
            # the batch replicated: the spec splits the heads, else N
            i = 0 if _cut(nheads) != nheads else 2
            ssm[i] = _cut(ssm[i])
        cache["ssm"] = zeros(L, batch, *ssm, dt=torch.float32)
        cache["conv"] = zeros(L, batch, cfg.ssm.conv_size - 1, _cut(inner))
        cache["k"] = zeros(G, batch, Sc, nkv, hd)
        cache["v"] = zeros(G, batch, Sc, nkv, hd)
    elif cfg.family == "hybrid_moe":   # typed stack, on one device
        inner, nheads, headdim, N = mamba_dims(cfg)
        A, M = len(cfg.attention_layers), len(cfg.mamba_layers)
        Sc = cache_len_for(cfg, seq_len, window)
        cache["k"] = zeros(A, batch, Sc, nkv, hd)
        cache["v"] = zeros(A, batch, Sc, nkv, hd)
        cache["conv"] = zeros(M, batch, cfg.ssm.conv_size - 1,
                              inner + 2 * N)
        cache["ssm"] = zeros(M, batch, nheads, headdim, N,
                             dt=torch.float32)
    else:
        raise ValueError(cfg.family)
    return cache


#: the cache leaves that hold attention's K/V; every other leaf but the
#: bookkeeping is a recurrent state
KV_LEAVES = ("k", "v", "k_pool", "v_pool", "cross_k", "cross_v")
BOOK_LEAVES = ("len", "pos", "block_table")


def cache_bytes(cache: dict):
    """(K/V bytes, recurrent-state bytes) of a cache's leaves."""
    size = lambda names: sum(t.numel() * t.element_size()
                             for k, t in cache.items() if k in names)
    state = [k for k in cache if k not in KV_LEAVES + BOOK_LEAVES]
    return size(KV_LEAVES), size(state)


def _write_kv(cache_k_l, cache_v_l, k, v, lens, mode: str,
              mask=None, span=None) -> None:
    """Write new K/V into one layer's cache, in place. Handles ring buffers.

    cache_k_l: (B, Sc, nkv, hd); k: (B, S_new, nkv, hd); lens: (B,) current
    per-sequence lengths (write positions). Prefill assumes fresh rows:
    entries land at slots 0..S_new-1, or, when S_new >= Sc, the last Sc
    entries rotated into ring order (the reference's ``jnp.roll``).
    Mode "chunk": an S_new-wide slab at each row's offset, only for rows in
    ``mask`` (B,); other rows keep their entries.

    ``span`` = (lo, S) (:func:`kv_span`): the cache is this rank's slots
    lo.. of S, and only the entries that land there are written.
    """
    if span is not None:
        _write_kv_block(cache_k_l, cache_v_l, k, v, lens, mode, span)
        return
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


def _write_kv_block(cache_k_l, cache_v_l, k, v, lens, mode: str,
                    span) -> None:
    """:func:`_write_kv` on the rank's slots lo..lo+n-1 of a cache of S:
    the single-device write's image, cut to the block."""
    lo, Sc = span
    n, S_new = cache_k_l.shape[1], k.shape[1]
    if mode == "decode":
        rows = torch.arange(k.shape[0], device=k.device)
        local = lens.long() % Sc - lo
        mine = ((local >= 0) & (local < n))[:, None, None]
        slot = torch.clamp(local, 0, n - 1)
        cache_k_l[rows, slot] = torch.where(mine, k[:, 0].to(cache_k_l.dtype),
                                            cache_k_l[rows, slot])
        cache_v_l[rows, slot] = torch.where(mine, v[:, 0].to(cache_v_l.dtype),
                                            cache_v_l[rows, slot])
    elif mode == "prefill":
        if S_new >= Sc:
            s0 = S_new % Sc
            cache_k_l.copy_(torch.roll(k[:, -Sc:], s0, dims=1)[:, lo:lo + n])
            cache_v_l.copy_(torch.roll(v[:, -Sc:], s0, dims=1)[:, lo:lo + n])
        else:
            m = max(0, min(n, S_new - lo))
            cache_k_l[:, :m] = k[:, lo:lo + m]
            cache_v_l[:, :m] = v[:, lo:lo + m]
    else:
        raise NotImplementedError(
            f"KV write mode {mode!r} on a cache split over the model axes "
            "(chunked prefill under tensor parallelism: beyond the "
            "reference, ROADMAP 'Beyond the reference')")


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
    """A stage's slice of a dense/MoE stack's parameters: every stacked
    per-layer leaf (the ``moe`` subtree's too) keeps rows [lo, hi) (a
    view); ``final_ln`` ships only with the last stage (it runs after the
    full depth). The stages run one after another compose to the full
    stack exactly."""
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
# Dense decoder stack (also the VLM decoder and whisper's, with cross_kv)
# ---------------------------------------------------------------------------


def init_dense_stack(gen: torch.Generator, cfg: ModelConfig, device):
    """Seeded weights of the dense/MoE stack in the reference's layout:
    every per-layer leaf stacked on a leading L axis, weights (in, out);
    an encoder-decoder adds each layer's cross attention and its norm."""
    dt = torch_dtype(cfg.dtype)
    L, d = cfg.num_layers, cfg.d_model
    ones = lambda *shape: torch.ones(shape, dtype=dt, device=device)
    p = {"ln1": ones(L, d), "ln2": ones(L, d),
         "attn": init_attention(gen, cfg, device, stacked=L)}
    if cfg.moe is not None:
        p["moe"] = init_moe(gen, cfg, device, stacked=L)
    else:
        p["mlp"] = init_mlp(gen, cfg, device, stacked=L)
    if cfg.is_encdec:
        p["ln_cross"] = ones(L, d)
        p["cross"] = init_attention(gen, cfg, device, stacked=L)
    p["final_ln"] = ones(d)
    return p


def _unstack(tree) -> list:
    """The per-layer slices of a stacked parameter tree, as views
    (``torch.unbind``): under autograd the layers' gradients are stacked
    in one op, where indexing layer by layer would pad each layer's
    gradient to the whole stack with zeros and add them."""
    if isinstance(tree, dict):
        per = {k: _unstack(v) for k, v in tree.items()}
        n = len(next(iter(per.values())))
        return [{k: v[i] for k, v in per.items()} for i in range(n)]
    return torch.unbind(tree, 0)


def _bump_len(cache: dict, S_new: int) -> dict:
    """A new dict with ``len`` and ``pos`` advanced by ``S_new``."""
    cache = dict(cache)
    cache["len"] = cache["len"] + S_new
    cache["pos"] = cache["pos"] + S_new
    return cache


def _run_layer(fn, remat: bool, *args):
    """``fn(*args)``; with ``remat`` under a non-reentrant checkpoint, so
    the backward recomputes the layer from its input."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _train_aux(mode: str, x):
    """The aux loss's start: a float32 zero in train mode, the number 0
    otherwise (no tensor, so serving launches nothing for it)."""
    return torch.zeros((), device=x.device) if mode == "train" else 0.0


def apply_dense_stack(params, x, positions, cfg: ModelConfig, cache,
                      mode: str, window: Optional[int] = None,
                      remat: bool = False, enc_out=None, chunk_mask=None,
                      chunk_counts=None, final_norm: bool = True):
    """x: (B, S, d). Returns (y, cache, aux), y final-normed unless
    ``final_norm=False``: a pipeline stage that is not the last hands its
    residual stream to the next stage raw (its ``params`` then need not
    carry ``final_ln``). The layers are those ``params`` carry, so a
    stage's slice runs its own layers. ``cache`` is None in train mode.

    An encoder-decoder (whisper) takes the encoder's output ``enc_out``
    in train and prefill mode: each layer projects its cross K/V from it,
    and prefill stores them in the cache for decode to read back.

    ``chunk_mask`` (B,) selects the rows of a "chunk" call whose K/V are
    written; ``chunk_counts`` (B,) gives each row's valid tokens in the
    slab (the paged pool scatter needs them; the contiguous slab write
    does not)."""
    eps = cfg.rmsnorm_eps
    if cfg.family == "audio":        # whisper: LayerNorm, bias-free here
        norm = lambda h, w: layer_norm(h, w, torch.zeros_like(w), eps)
    else:
        norm = lambda h, w: rms_norm(h, w, eps)
    win = cfg.sliding_window if window is None else window
    train = mode == "train"
    assert train == (cache is None), "a cache in all modes but train"
    compute_cross = cfg.is_encdec and mode in ("train", "prefill")
    if compute_cross and enc_out is None:
        raise ValueError(f"{cfg.name}: {mode} needs the encoder's output "
                         "(batch['frames'])")
    lens0 = None if train else cache["len"]
    paged = not train and "k_pool" in cache
    if paged and dist.tp_size() > 1:
        raise NotImplementedError("a paged cache under tensor parallelism "
                                  "(beyond the reference, ROADMAP 'Beyond "
                                  "the reference')")
    span = None if train or paged else kv_span(cache["k"].shape[2])
    cross_split = cfg.is_encdec and not train and dist.split_block(
        cache["cross_k"].shape[2], cfg.encoder.num_frames)
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

    def layer(x, lp, i):
        h = norm(x, lp["ln1"])
        if mode in ("decode", "chunk"):
            # valid entries after a decode write; a chunk attends from its
            # offsets
            kv_len = lens0 + 1 if mode == "decode" else lens0
            if paged:
                # this layer's contiguous view of the pool: a per-step
                # temporary the cached attention runs on unchanged
                ck = gather_block_view(cache["k_pool"][i], bt, blk)
                cv = gather_block_view(cache["v_pool"][i], bt, blk)
            else:
                ck, cv = cache["k"][i], cache["v"][i]
            # write first so each token attends to itself
            qkv = _project_qkv(lp["attn"], h, cfg, positions, rt)
            _write_kv(ck, cv, qkv[1], qkv[2], lens0, mode, chunk_mask, span)
            attn_out, _, _ = attention_block(
                lp["attn"], h, cfg, positions, cache_k=ck, cache_v=cv,
                kv_len=kv_len, mode=mode, window=win, qkv=qkv,
                kv_span=span)
            if paged:
                # persist only the new entries
                scatter_block_kv(cache["k_pool"][i], qkv[1], pool_flat)
                scatter_block_kv(cache["v_pool"][i], qkv[2], pool_flat)
        elif mode in ("train", "prefill"):
            attn_out, k, v = attention_block(lp["attn"], h, cfg, positions,
                                             mode="train", window=win,
                                             rope_tables=rt)
            if mode == "prefill":
                _write_kv(cache["k"][i], cache["v"][i], k, v, lens0,
                          "prefill", span=span)
        else:
            raise ValueError(f"unknown stack mode {mode!r}")
        x = x + attn_out
        if cfg.is_encdec:
            if compute_cross:
                ckv = project_enc_kv(lp["cross"], enc_out, cfg)
                if not train:
                    n = cache["cross_k"].shape[2]
                    own = (lambda t: dist.model_block(t, 1, n)) \
                        if cross_split else (lambda t: t)
                    cache["cross_k"][i].copy_(own(ckv[0]))
                    cache["cross_v"][i].copy_(own(ckv[1]))
            else:
                ckv = (cache["cross_k"][i], cache["cross_v"][i])
            x = x + cross_attention_block(
                lp["cross"], norm(x, lp["ln_cross"]), ckv, cfg)
        h2 = norm(x, lp["ln2"])
        if cfg.moe is not None:
            ff, aux_l = apply_moe(lp["moe"], h2, cfg, train=train)
        else:
            ff, aux_l = apply_mlp(lp["mlp"], h2, cfg.act, cfg.d_ff), 0.0
        return x + ff, aux_l

    aux = _train_aux(mode, x)
    for i, lp in enumerate(_unstack(layers)):
        x, aux_l = _run_layer(layer, remat and train, x, lp, i)
        if cfg.moe is not None:
            aux = aux + aux_l
    if not train:
        cache = _bump_len(cache, positions.shape[-1])
    if final_norm:
        x = norm(x, params["final_ln"])
    return x, cache, aux


# ---------------------------------------------------------------------------
# RWKV-6 stack
# ---------------------------------------------------------------------------


def init_rwkv_stack(gen: torch.Generator, cfg: ModelConfig, device):
    """Seeded RWKV-6 stack weights in the reference's layout."""
    dt = torch_dtype(cfg.dtype)
    L, d = cfg.num_layers, cfg.d_model
    ones = lambda *shape: torch.ones(shape, dtype=dt, device=device)
    return {"ln1": ones(L, d), "ln2": ones(L, d),
            "layers": init_rwkv(gen, cfg, device, stacked=L),
            "final_ln": ones(d)}


def apply_rwkv_stack(params, x, positions, cfg: ModelConfig, cache,
                     mode: str, window: Optional[int] = None,
                     remat: bool = False):
    """x: (B, S, d). Train, prefill and decode alike run the time-mix
    recurrence over the S tokens, from zero states in train mode and from
    the cached state otherwise (a right-padded prompt's pad tokens are
    scanned into it, as in the reference). Returns (y, cache, aux), the
    states written in place; aux is 0 (no MoE)."""
    assert mode in ("train", "prefill", "decode"), \
        f"the RWKV stack runs train, prefill and decode, not {mode!r}"
    eps = cfg.rmsnorm_eps
    train = mode == "train"
    d = cfg.d_model
    if train:
        state0 = torch.zeros((x.shape[0],) + rwkv_state_shape(
            params["layers"]["w_r"].shape[-1], d, cfg.ssm.rwkv_head_size),
            device=x.device)
        last0 = x.new_zeros((x.shape[0], d))
    else:
        # the token shifts' blocks made whole once a step
        n = cache["x_last_t"].shape[-1]
        shift_split = dist.split_block(n, d)
        lasts = dist.gather_cols([cache["x_last_t"], cache["x_last_c"]]) \
            if shift_split else [cache["x_last_t"], cache["x_last_c"]]
        own = (lambda t: dist.model_block(t, -1, n)) if shift_split \
            else (lambda t: t)

    def layer(x, lp, ln1, ln2, st, lt, lc):
        tm, lt, st = rwkv_time_mix_seq(lp, rms_norm(x, ln1, eps), lt, st,
                                       cfg)
        x = x + tm
        cm, lc = rwkv_channel_mix_seq(lp, rms_norm(x, ln2, eps), lc,
                                      cfg.d_ff)
        return x + cm, st, lt, lc

    per_layer = zip(_unstack(params["layers"]), _unstack(params["ln1"]),
                    _unstack(params["ln2"]))
    for i, (lp, ln1, ln2) in enumerate(per_layer):
        states = (state0, last0, last0) if train else (
            cache["ssm"][i], lasts[0][i], lasts[1][i])
        x, st, lt, lc = _run_layer(layer, remat and train, x, lp, ln1, ln2,
                                   *states)
        if not train:
            cache["ssm"][i].copy_(st)
            cache["x_last_t"][i].copy_(own(lt))
            cache["x_last_c"][i].copy_(own(lc))
    if not train:
        cache = _bump_len(cache, x.shape[1])
    return rms_norm(x, params["final_ln"], eps), cache, _train_aux(mode, x)


def _cached_attention(p, h, cfg: ModelConfig, positions, cache, g: int,
                      lens0, mode: str, *, window: int, rt=None, span=None,
                      scale: Optional[float] = None):
    """A recurrent stack's attention over site g of the contiguous
    cache's ``k``/``v``. Decode writes the token's K/V first, so that it
    attends to itself, and attends over ``lens0 + 1``; train and prefill
    attend within the call, and prefill writes the call's K/V at
    ``lens0``. ``span``: as :func:`attention_block`'s ``kv_span``."""
    if mode == "decode":
        ck, cv = cache["k"][g], cache["v"][g]
        qkv = _project_qkv(p, h, cfg, positions, rt)
        _write_kv(ck, cv, qkv[1], qkv[2], lens0, "decode", span=span)
        out, _, _ = attention_block(p, h, cfg, positions, cache_k=ck,
                                    cache_v=cv, kv_len=lens0 + 1,
                                    mode="decode", window=window, qkv=qkv,
                                    kv_span=span, scale=scale)
        return out
    out, k, v = attention_block(p, h, cfg, positions, mode="train",
                                window=window, rope_tables=rt, scale=scale)
    if mode == "prefill":
        _write_kv(cache["k"][g], cache["v"][g], k, v, lens0, "prefill",
                  span=span)
    return out


# ---------------------------------------------------------------------------
# Zamba2 hybrid stack: groups of mamba layers + a shared attention block
# ---------------------------------------------------------------------------


def init_zamba_stack(gen: torch.Generator, cfg: ModelConfig, device):
    """Seeded Zamba2 stack weights in the reference's layout: the Mamba2
    layers stacked, one shared attention block and MLP."""
    dt = torch_dtype(cfg.dtype)
    L, d = cfg.num_layers, cfg.d_model
    ones = lambda *shape: torch.ones(shape, dtype=dt, device=device)
    return {"ln_m": ones(L, d),
            "mamba": init_mamba(gen, cfg, device, stacked=L),
            "shared_ln1": ones(d), "shared_ln2": ones(d),
            "shared_attn": init_attention(gen, cfg, device),
            "shared_mlp": init_mlp(gen, cfg, device),
            "final_ln": ones(d)}


def apply_zamba_stack(params, x, positions, cfg: ModelConfig, cache,
                      mode: str, window: Optional[int] = None,
                      remat: bool = False):
    """x: (B, S, d). Before each group of ``attn_every`` Mamba2 layers the
    shared attention block (site g of the K/V cache) and the shared MLP
    run; the attention is a ring buffer over the window (4096 unless the
    arch or ``window`` sets one). Train mode starts the Mamba2 states at
    zero and checkpoints each Mamba2 layer under ``remat``, as the
    reference does. Returns (y, cache, aux), the states written in place;
    aux is 0 (no MoE)."""
    assert mode in ("train", "prefill", "decode"), \
        f"the Zamba2 stack runs train, prefill and decode, not {mode!r}"
    eps = cfg.rmsnorm_eps
    L, every = cfg.num_layers, cfg.hybrid.attn_every
    win = window if window is not None else (cfg.sliding_window or 4096)
    train = mode == "train"
    if train:
        B = x.shape[0]
        inner, nheads, headdim, N = mamba_dims(cfg)
        conv0 = x.new_zeros((B, cfg.ssm.conv_size - 1, inner))
        ssm0 = torch.zeros((B, nheads, headdim, N), device=x.device)
        lens0 = span = None
    else:
        lens0 = cache["len"]
        span = kv_span(cache["k"].shape[2])
        # Mamba2 runs whole: the state blocks the cache holds (the conv
        # carry's channels; the SSM state's where the spec splits it) are
        # made whole once a step, and each layer writes back its block
        inner, nheads, headdim, N = mamba_dims(cfg)
        whole = {"conv": (None, None, None, inner),
                 "ssm": (None, None, nheads, headdim, N)}
        states, owns = {}, {}
        for name, dims in whole.items():
            leaf = cache[name]
            sd = [i for i, w in enumerate(dims)
                  if w is not None and dist.split_block(leaf.shape[i], w)]
            assert len(sd) <= 1, (name, tuple(leaf.shape))
            if sd:
                n = leaf.shape[sd[0]]
                states[name] = dist.gather_model(leaf, sd[0])
                owns[name] = (lambda t, i=sd[0] - 1, n=n:
                              dist.model_block(t, i, n))
            else:
                states[name] = leaf
                owns[name] = lambda t: t
    rt = rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta) \
        if cfg.rope_theta > 0 else None
    attn_p = params["shared_attn"]
    mamba_p, ln_m = _unstack(params["mamba"]), _unstack(params["ln_m"])

    def mamba_layer(x, lp, ln, conv, ssm):
        out, conv, ssm = mamba_seq(lp, rms_norm(x, ln, eps), conv, ssm, cfg)
        return x + out, conv, ssm

    for g, lo in enumerate(range(0, L, every)):
        h = rms_norm(x, params["shared_ln1"], eps)
        x = x + _cached_attention(attn_p, h, cfg, positions, cache, g,
                                  lens0, mode, window=win, rt=rt,
                                  span=span)
        x = x + apply_mlp(params["shared_mlp"],
                          rms_norm(x, params["shared_ln2"], eps), cfg.act,
                          cfg.d_ff)
        for i in range(lo, min(lo + every, L)):
            st = (conv0, ssm0) if train else (states["conv"][i],
                                              states["ssm"][i])
            x, conv, ssm = _run_layer(mamba_layer, remat and train, x,
                                      mamba_p[i], ln_m[i], *st)
            if not train:
                cache["conv"][i].copy_(owns["conv"](conv))
                cache["ssm"][i].copy_(owns["ssm"](ssm))
    if not train:
        cache = _bump_len(cache, x.shape[1])
    return rms_norm(x, params["final_ln"], eps), cache, _train_aux(mode, x)


# ---------------------------------------------------------------------------
# Typed stack (Granite 4.0-H): per-layer Mamba2 or NoPE attention, MoE after
# ---------------------------------------------------------------------------

#: the most tokens a prefill's dropless MoE takes in one call: larger
#: calls go in row groups (each expert's bucket holds every token of its
#: call, E·T rows of d, ~2.5 MB a token at Granite 4.0-H Small's widths)
MOE_PREFILL_TOKENS = 4096


def init_typed_stack(gen: torch.Generator, cfg: ModelConfig, device):
    """Seeded typed-stack weights: the M Mamba2 mixers stacked on one
    leading axis, the A attention mixers on another (in layer order), the
    MoE (its shared expert included) and both norms on the L axis."""
    dt = torch_dtype(cfg.dtype)
    L, d = cfg.num_layers, cfg.d_model
    ones = lambda *shape: torch.ones(shape, dtype=dt, device=device)
    p = {"ln1": ones(L, d), "ln2": ones(L, d)}
    M, A = len(cfg.mamba_layers), len(cfg.attention_layers)
    if M:
        p["mamba"] = init_mamba(gen, cfg, device, stacked=M, xbc=True)
    if A:
        p["attn"] = init_attention(gen, cfg, device, stacked=A)
    p["moe"] = init_moe(gen, cfg, device, stacked=L)
    p["final_ln"] = ones(d)
    return p


def _typed_moe(lp, h, cfg: ModelConfig, mode: str):
    """The MoE of one layer; a prefill call of more than
    ``MOE_PREFILL_TOKENS`` tokens runs in row groups where routing is
    dropless (capacity >= experts / top-k), so no row's result depends
    on the others of its call."""
    B, T = h.shape[0], h.shape[1]
    m = cfg.moe
    dropless = m.capacity_factor * m.top_k >= m.num_experts
    if mode != "prefill" or B * T <= MOE_PREFILL_TOKENS or not dropless:
        return apply_moe(lp, h, cfg, train=mode == "train")
    rows = max(1, MOE_PREFILL_TOKENS // T)
    return torch.cat([apply_moe(lp, h[r:r + rows], cfg)[0]
                      for r in range(0, B, rows)]), 0.0


def apply_typed_stack(params, x, positions, cfg: ModelConfig, cache,
                      mode: str, window: Optional[int] = None,
                      remat: bool = False, lens=None):
    """x: (B, S, d). Layer i runs its mixer by ``cfg.layer_types[i]`` —
    Mamba2 (the published mixer, its conv carry and SSM state in the
    cache's ``conv``/``ssm`` at the layer's Mamba2 index) or attention
    without positions (NoPE: ``rope_theta`` 0) scaled by
    ``attention_multiplier`` (K/V at its attention index) — then the MoE
    (shared expert included); ``residual_multiplier`` scales both
    branches. ``lens`` (B,): the rows' lengths of a right-padded prefill,
    so a row's Mamba2 state is held at its own last token. Each Mamba2
    mixer is a ``mamba`` span (``obs.tracer.current()``; device-timed).
    Train mode starts the states at zero. Returns (y, cache, aux)."""
    assert mode in ("train", "prefill", "decode"), \
        f"the typed stack runs train, prefill and decode, not {mode!r}"
    if dist.get_ctx().active:
        raise NotImplementedError("the typed stack under a mesh")
    eps, rm = cfg.rmsnorm_eps, cfg.residual_multiplier
    train = mode == "train"
    B, S = x.shape[0], x.shape[1]
    if train:
        inner, nheads, headdim, N = mamba_dims(cfg)
        conv0 = x.new_zeros((B, cfg.ssm.conv_size - 1, inner + 2 * N))
        ssm0 = torch.zeros((B, nheads, headdim, N), device=x.device)
        lens0 = None
    else:
        lens0 = cache["len"]
    # layer i's index among the layers of its kind: the leading axis of
    # its mixer's weights and of its cache leaves
    index = {i: j for layers in (cfg.mamba_layers, cfg.attention_layers)
             for j, i in enumerate(layers)}
    mixers = {kind: _unstack(params[key]) if key in params else []
              for kind, key in (("mamba", "mamba"), ("attention", "attn"))}
    tracer = current_tracer()

    def mamba(h, lp, j, i):
        st = (conv0, ssm0) if train else (cache["conv"][j],
                                          cache["ssm"][j])
        with tracer.span("mamba", device=x.device, layer=i, rows=B,
                         tokens=B * S, program=mode):
            out, conv, ssm = mamba_xbc_seq(lp, h, *st, cfg, lens=lens)
            if not train:
                cache["conv"][j].copy_(conv)
                cache["ssm"][j].copy_(ssm)
        return out

    def layer(x, ln1, ln2, moe_p, kind, lp, j, i):
        h = rms_norm(x, ln1, eps)
        x = x + rm * (mamba(h, lp, j, i) if kind == "mamba" else
                      _cached_attention(lp, h, cfg, positions, cache, j,
                                        lens0, mode, window=0,
                                        scale=cfg.softmax_scale))
        ff, aux_l = _typed_moe(moe_p, rms_norm(x, ln2, eps), cfg, mode)
        return x + rm * ff, aux_l

    aux = _train_aux(mode, x)
    per_layer = zip(cfg.layer_types, _unstack(params["ln1"]),
                    _unstack(params["ln2"]), _unstack(params["moe"]))
    for i, (kind, ln1, ln2, moe_p) in enumerate(per_layer):
        j = index[i]
        x, aux_l = _run_layer(layer, remat and train, x, ln1, ln2, moe_p,
                              kind, mixers[kind][j], j, i)
        aux = aux + aux_l
    if not train:
        cache = _bump_len(cache, S)
    return rms_norm(x, params["final_ln"], eps), cache, aux


# ---------------------------------------------------------------------------
# Whisper encoder
# ---------------------------------------------------------------------------


def init_encoder(gen: torch.Generator, cfg: ModelConfig, device):
    """Seeded encoder weights in the reference's layout: learned frame
    positions and a stack of bidirectional layers."""
    dt = torch_dtype(cfg.dtype)
    Le, d = cfg.encoder.num_layers, cfg.d_model
    ones = lambda *shape: torch.ones(shape, dtype=dt, device=device)
    return {"pos": dense_init(gen, (cfg.encoder.num_frames, d), dt, device,
                              scale=0.02),
            "ln1": ones(Le, d), "ln2": ones(Le, d),
            "attn": init_attention(gen, cfg, device, stacked=Le),
            "mlp": init_mlp(gen, cfg, device, stacked=Le),
            "final_ln": ones(d)}


def apply_encoder(params, frames, cfg: ModelConfig):
    """frames: (B, S_enc, d) precomputed stub embeddings -> the encoder's
    output (B, S_enc, d): learned positions, then pre-LayerNorm layers of
    unmasked self-attention (no RoPE) and MLP, then a final LayerNorm."""
    eps = cfg.rmsnorm_eps
    ln = lambda h, w: layer_norm(h, w, torch.zeros_like(w), eps)
    x = frames + params["pos"][None, :frames.shape[1]].to(frames.dtype)
    B, S = x.shape[0], x.shape[1]
    for lp in _unstack({k: params[k] for k in ("ln1", "ln2", "attn", "mlp")}):
        q, k, v = _project_qkv(lp["attn"], ln(x, lp["ln1"]), cfg, None,
                               rope=False)
        out = attend_full(_expand_gqa(q, cfg.num_kv_heads), k, v,
                          causal=False, window=0).reshape(B, S, -1)
        x = x + _out_proj(out, lp["attn"]["w_o"], out.dtype)
        x = x + apply_mlp(lp["mlp"], ln(x, lp["ln2"]), cfg.act, cfg.d_ff)
    return ln(x, params["final_ln"])
