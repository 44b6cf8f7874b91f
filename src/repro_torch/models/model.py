"""Model facade: a uniform interface over all six architecture families
(the reference's ``Model``).

    model = Model(cfg)
    params = model.init(seed=0, device="cuda")              # port's own init
    logits, aux = model.train_logits(params, batch)  # (B, S, V) f32, aux
    cache = model.init_cache(B, S, device="cuda")
    logits, cache = model.prefill(params, batch, cache,
                                  true_lens=lens)        # (B, V) f32
    logits, cache = model.prefill_chunk(params, toks, cache, counts,
                                        mask)                # (B, V) f32
    logits, cache = model.decode_step(params, tokens, cache)  # (B, V) f32
    out, cache = model.decode_stage(stage_params, x_or_tokens, stage_cache,
                                    first=..., last=...)  # one stage

``batch`` is a dict: always ``tokens (B, S)``; the VLM adds
``patch_embeds (B, P, d)``, placed before the text; the audio family
(whisper) adds ``frames (B, F, d)``, which the encoder reads (both are the
stubbed modality frontends' precomputed embeddings, cast to the
parameters' dtype here; the reference computes the encoder in the frames'
dtype). ``params`` is the reference's tree (``{"emb": {...}, "stack":
{...}}``, plus ``"encoder"`` and the learned decoder positions
``"dec_pos"`` for whisper; weights ``(in, out)``, per-layer leaves stacked
on a leading L axis); the reference's own init comes across through
:mod:`repro_torch.models.bridge`.
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import dist
from repro_torch.models.layers import (dense_init, embed, init_embeddings,
                                      lm_head, torch_dtype)
from repro_torch.models.transformer import (apply_dense_stack, apply_encoder,
                                            apply_rwkv_stack,
                                            apply_zamba_stack, init_cache,
                                            init_dense_stack, init_encoder,
                                            init_rwkv_stack, init_zamba_stack)

_DENSE_FAMILIES = ("dense", "moe", "vlm", "audio")
# family -> (stack init, stack forward)
_STACKS = {**{f: (init_dense_stack, apply_dense_stack)
              for f in _DENSE_FAMILIES},
           "ssm": (init_rwkv_stack, apply_rwkv_stack),
           "hybrid": (init_zamba_stack, apply_zamba_stack)}
DEC_POSITIONS = 32768        # whisper's learned decoder positions (sliced)


class Model:
    def __init__(self, cfg: ModelConfig):
        if cfg.family not in _STACKS:
            raise ValueError(cfg.family)
        self.cfg = cfg
        self._init_stack, self._apply_stack = _STACKS[cfg.family]

    # -- init ---------------------------------------------------------------
    def init(self, seed: int = 0, device="cuda") -> dict:
        """Seeded random weights in the reference's layout, made on
        ``device`` (not the reference's values: use the bridge for those)."""
        cfg = self.cfg
        dev = resolve_device(device)
        g = torch.Generator(device=dev).manual_seed(seed)
        params = {"emb": init_embeddings(g, cfg, dev),
                  "stack": self._init_stack(g, cfg, dev)}
        if cfg.is_encdec:
            params["encoder"] = init_encoder(g, cfg, dev)
            params["dec_pos"] = dense_init(
                g, (DEC_POSITIONS, cfg.d_model), torch_dtype(cfg.dtype), dev,
                scale=0.02)
        return params

    def init_cache(self, batch: int, seq_len: int, window=None, dtype=None,
                   device="cuda"):
        return init_cache(self.cfg, batch, seq_len, window, dtype,
                          resolve_device(device))

    # -- embedding / input assembly -------------------------------------------
    def _embed_inputs(self, params, batch, lens=None):
        """Returns (x (B,S,d), positions (B,S), enc_out or None); ``lens``
        are the rows' current lengths (decode), None for fresh
        prefill/train (positions start at 0)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = embed(params["emb"], tokens)
        enc_out = None
        if cfg.family == "vlm" and "patch_embeds" in batch:
            x = torch.cat([batch["patch_embeds"].to(x.dtype), x], dim=1)
        if cfg.is_encdec and "frames" in batch:
            enc_out = apply_encoder(params["encoder"],
                                    batch["frames"].to(x.dtype), cfg)
        B, S = x.shape[0], x.shape[1]
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device)[None, :]
        positions = positions.expand(B, S) if lens is None \
            else lens[:, None] + positions
        if cfg.is_encdec:
            # learned decoder positions (RoPE off: rope_theta = 0)
            dec_pos = params["dec_pos"]
            idx = torch.clamp(positions, max=dec_pos.shape[0] - 1)
            x = x + embed({"tok": dec_pos}, idx).to(x.dtype)
        return x, positions, enc_out

    def _stack(self, params, x, positions, cache, mode, window=None,
               remat=False, enc_out=None):
        kw = {"enc_out": enc_out} if self.cfg.family in _DENSE_FAMILIES \
            else {}
        return self._apply_stack(params["stack"], x, positions, self.cfg,
                                 cache, mode, window=window, remat=remat,
                                 **kw)

    @staticmethod
    def _logits(params, y):
        """The LM head. Under a mesh whose model axes' size t divides V,
        only the rank's V block (``(b, V/t)``: columns ``r·V/t`` on, r its
        model index) — the logits leave the head sharded (B@batch,
        V@model), the paper's starting condition for the decision plane;
        whole rows otherwise. The head's weight is whole on every rank
        (the dense weights are replicated), and the block is its slice."""
        emb = params["emb"]
        ctx = dist.get_ctx()
        tp = ctx.axis_size(ctx.model_axes)
        V = emb["head"].shape[-1] if "head" in emb else emb["tok"].shape[0]
        if not ctx.active or tp <= 1 or V % tp:
            return lm_head(emb, y)
        lo = dist.axis_index(ctx.model_axes) * (V // tp)
        if "head" in emb:
            block = {"head": emb["head"][:, lo:lo + V // tp]}
        else:
            block = {"tok": emb["tok"][lo:lo + V // tp]}
        return lm_head(block, y)

    @staticmethod
    def _patches(batch) -> int:
        pe = batch.get("patch_embeds")
        return 0 if pe is None else pe.shape[1]

    # -- entry points ---------------------------------------------------------
    def train_logits(self, params, batch, remat: bool = True):
        """Full-sequence logits for training: (logits (B, S, V) f32, aux),
        the patch positions of a VLM batch dropped (the loss is on the
        text). ``remat`` checkpoints each layer."""
        x, positions, enc_out = self._embed_inputs(params, batch)
        y, _, aux = self._stack(params, x, positions, None, "train",
                                remat=remat, enc_out=enc_out)
        if self.cfg.family == "vlm":
            y = y[:, self._patches(batch):]
        return self._logits(params, y), aux

    def prefill(self, params, batch, cache, window=None, true_lens=None):
        """Process prompts (fresh rows). Returns (last-pos logits (B,V),
        cache). ``true_lens``: per-row prompt lengths of a right-padded
        batch; logits are taken at position true_len-1 (after a VLM
        batch's patches) and cache["len"] is set to it. Whisper needs
        ``batch["frames"]``: prefill stores their cross K/V for decode."""
        x, positions, enc_out = self._embed_inputs(params, batch)
        y, cache, _ = self._stack(params, x, positions, cache, "prefill",
                                  window=window, enc_out=enc_out)
        if true_lens is not None:
            B = y.shape[0]
            off = self._patches(batch) if self.cfg.family == "vlm" else 0
            idx = torch.clamp(off + true_lens.long() - 1, 0, y.shape[1] - 1)
            y_last = y[torch.arange(B, device=y.device), idx]
            cache = dict(cache)
            cache["len"] = torch.zeros_like(cache["len"]) + off + true_lens
        else:
            y_last = y[:, -1]
        return self._logits(params, y_last), cache
    def prefill_chunk(self, params, tokens, cache, counts, mask):
        """Continue prefilling in place: write ``counts[b]`` prompt tokens
        (right-padded to the chunk width C) for rows where ``mask[b]``,
        starting at each row's current ``cache["len"]``.

        tokens: (B, C) int32; counts: (B,) int32; mask: (B,) bool. Rows
        outside the mask keep their cache entries and their ``len``.
        Returns (logits at each row's last valid chunk position (B, V),
        cache). Full-causal dense/MoE decoders only (the engine gates it);
        works on contiguous and paged caches alike."""
        cfg = self.cfg
        assert cfg.family in ("dense", "moe") and not cfg.sliding_window, \
            "chunked prefill: full-causal dense only"
        lens0 = cache["len"]
        x, positions, _ = self._embed_inputs(params, {"tokens": tokens},
                                             lens=lens0)
        y, cache, _ = apply_dense_stack(params["stack"], x, positions, cfg,
                                        cache, "chunk", chunk_mask=mask,
                                        chunk_counts=counts)
        B, C = tokens.shape
        idx = torch.clamp(counts.long() - 1, 0, C - 1)
        y_last = y[torch.arange(B, device=y.device), idx]
        cache = dict(cache)
        cache["len"] = lens0 + torch.where(mask, counts, 0).to(lens0.dtype)
        return self._logits(params, y_last), cache

    def decode_step(self, params, tokens, cache, window=None):
        """One decode iteration. tokens: (B,) or (B,1). Returns
        (logits (B, V), cache)."""
        if tokens.dim() == 1:
            tokens = tokens[:, None]
        x, positions, _ = self._embed_inputs(params, {"tokens": tokens},
                                             lens=cache["len"])
        y, cache, _ = self._stack(params, x, positions, cache, "decode",
                                  window=window)
        return self._logits(params, y[:, -1]), cache

    def decode_stage(self, stage_params, x_or_tokens, cache, *, first: bool,
                     last: bool, window=None):
        """One pipeline stage of :meth:`decode_step`. The stages, run one
        after another on their layer slices, compose to the full decode
        exactly: the first stage embeds, the last closes with the final
        norm and the LM head.

        ``stage_params``: ``{"stack": sliced stack}`` plus ``"emb"`` on the
        first stage (input embedding) and the last (tied LM head: the same
        tensor on both). ``cache`` is the stage's layer-sliced cache.
        Returns ``(activations (B, 1, d), cache)`` for inner stages and
        ``(logits (B, V), cache)`` for the last. Dense/MoE decoders only
        (the pipeline engine gates it)."""
        assert self.cfg.family in ("dense", "moe"), \
            "pipeline stages: dense/moe decoder archs only"
        if first:
            tokens = x_or_tokens
            if tokens.dim() == 1:
                tokens = tokens[:, None]
            x, positions, _ = self._embed_inputs(
                stage_params, {"tokens": tokens}, lens=cache["len"])
        else:
            x = x_or_tokens
            positions = cache["len"][:, None] + torch.arange(
                x.shape[1], dtype=torch.int32, device=x.device)[None, :]
        y, cache, _ = apply_dense_stack(stage_params["stack"], x, positions,
                                        self.cfg, cache, "decode",
                                        window=window, final_norm=last)
        if last:
            return self._logits(stage_params, y[:, -1]), cache
        return y, cache
