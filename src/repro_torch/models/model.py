"""Model facade over the dense decoder (the reference's ``Model``).

    model = Model(cfg)
    params = model.init(seed=0, device="cuda")              # port's own init
    cache = model.init_cache(B, S, device="cuda")
    logits, cache = model.prefill(params, {"tokens": t}, cache,
                                  true_lens=lens)        # (B, V) f32
    logits, cache = model.decode_step(params, tokens, cache)  # (B, V) f32

``params`` is the reference's tree (``{"emb": {...}, "stack": {...}}``,
weights ``(in, out)``, per-layer leaves stacked on a leading L axis); the
reference's own init comes across through :mod:`repro_torch.models.bridge`.
Only the dense family is ported.
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import embed, init_embeddings, lm_head
from repro_torch.models.transformer import (apply_dense_stack, init_cache,
                                            init_dense_stack)


class Model:
    def __init__(self, cfg: ModelConfig):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"the {cfg.family!r} family is not ported yet (ROADMAP "
                "'Modules to port' item 11)")
        self.cfg = cfg

    # -- init ---------------------------------------------------------------
    def init(self, seed: int = 0, device="cuda") -> dict:
        """Seeded random weights in the reference's layout, made on
        ``device`` (not the reference's values: use the bridge for those)."""
        dev = resolve_device(device)
        g = torch.Generator(device=dev).manual_seed(seed)
        emb = init_embeddings(g, self.cfg, dev)
        return {"emb": emb, "stack": init_dense_stack(g, self.cfg, dev)}

    def init_cache(self, batch: int, seq_len: int, window=None, dtype=None,
                   device="cuda"):
        return init_cache(self.cfg, batch, seq_len, window, dtype,
                          resolve_device(device))

    # -- entry points ---------------------------------------------------------
    def _embed_inputs(self, params, tokens, lens=None):
        """Returns (x (B,S,d), positions (B,S)); ``lens`` are the rows'
        current lengths (decode), None for fresh prefill."""
        x = embed(params["emb"], tokens)
        B, S = tokens.shape
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None, :]
        positions = positions.expand(B, S) if lens is None \
            else lens[:, None] + positions
        return x, positions

    def prefill(self, params, batch, cache, window=None, true_lens=None):
        """Process prompts (fresh rows). Returns (last-pos logits (B,V),
        cache). ``true_lens``: per-row prompt lengths of a right-padded
        batch; logits are taken at position true_len-1 and cache["len"] is
        set to it."""
        x, positions = self._embed_inputs(params, batch["tokens"])
        y, cache = apply_dense_stack(params["stack"], x, positions,
                                     self.cfg, cache, "prefill",
                                     window=window)
        if true_lens is not None:
            B = y.shape[0]
            idx = torch.clamp(true_lens.long() - 1, 0, y.shape[1] - 1)
            y_last = y[torch.arange(B, device=y.device), idx]
            cache = dict(cache)
            cache["len"] = torch.zeros_like(cache["len"]) + true_lens
        else:
            y_last = y[:, -1]
        return lm_head(params["emb"], y_last), cache

    def decode_step(self, params, tokens, cache, window=None):
        """One decode iteration. tokens: (B,) or (B,1). Returns
        (logits (B, V), cache)."""
        if tokens.dim() == 1:
            tokens = tokens[:, None]
        x, positions = self._embed_inputs(params, tokens, lens=cache["len"])
        y, cache = apply_dense_stack(params["stack"], x, positions,
                                     self.cfg, cache, "decode",
                                     window=window)
        return lm_head(params["emb"], y[:, -1]), cache
