"""Penalty state + application (paper §2.2, Eq. 1 & Eq. 5).

* **Incremental updates** (Eq. 5): per-sequence histograms ``C_o`` are
  updated with only the newest token row (a one-index scatter-add), never
  rebuilt.
* **Batch-partitioned state**: every tensor here is leading-batch.

Penalties follow the paper's formulation:
  repetition: f = 1 + (λ_rep − 1) (M_p ∨ M_o);  Z' = Z / f
  presence:   Z' −= λ_pres · M_o
  frequency:  Z' −= λ_freq · C_o
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class PenaltyState(NamedTuple):
    """Per-sequence token statistics. Both tensors are (B, V) int32."""

    prompt_counts: torch.Tensor   # C_p — step-invariant
    output_counts: torch.Tensor   # C_o — updated each iteration

    @property
    def prompt_mask(self):
        return self.prompt_counts > 0

    @property
    def output_mask(self):
        return self.output_counts > 0


def init_state(batch: int, vocab_size: int,
               prompt_tokens: Optional[torch.Tensor] = None,
               prompt_lens: Optional[torch.Tensor] = None, *,
               device="cpu") -> PenaltyState:
    """Build state from (optionally right-padded) prompts.

    prompt_tokens: (B, L_p) int; prompt_lens: (B,) true lengths (None ->
    every column counts). With prompts given, their device is used.
    """
    if prompt_tokens is None:
        cp = torch.zeros((batch, vocab_size), dtype=torch.int32,
                         device=device)
    else:
        cp = histogram(prompt_tokens, vocab_size, prompt_lens)
    return PenaltyState(prompt_counts=cp,
                        output_counts=torch.zeros_like(cp))


def histogram(tokens: torch.Tensor, vocab_size: int,
              lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Hist(Y): (B, L) int tokens -> (B, V) int32 counts. Out-of-range ids
    are skipped (the reference's ``.at[].add(mode="drop")``)."""
    B, L = tokens.shape
    dev = tokens.device
    valid = torch.ones((B, L), dtype=torch.bool, device=dev) if lens is None \
        else torch.arange(L, device=dev)[None, :] < lens[:, None]
    t = tokens.long()
    valid = valid & (t >= 0) & (t < vocab_size)
    out = torch.zeros((B, vocab_size), dtype=torch.int32, device=dev)
    return out.scatter_add_(1, torch.where(valid, t, 0), valid.int())


def update_histograms(state: PenaltyState, new_tokens: torch.Tensor,
                      active: Optional[torch.Tensor] = None) -> PenaltyState:
    """Eq. 5: C_o^{s+1} = C_o^s + Hist(Y_s) — touch only the newest row.

    new_tokens: (B,) int; active: (B,) bool — finished sequences don't
    accumulate. Returns a new state; the input state is not modified.
    """
    V = state.output_counts.shape[1]
    t = new_tokens.long()
    inc = torch.ones_like(t, dtype=torch.bool) if active is None \
        else active.bool()
    inc = inc & (t >= 0) & (t < V)
    co = state.output_counts.clone()
    co.scatter_add_(1, torch.where(inc, t, 0)[:, None], inc.int()[:, None])
    return state._replace(output_counts=co)


def apply_penalties(logits: torch.Tensor, state: PenaltyState,
                    cfg) -> torch.Tensor:
    """Eq. 1 / §2.2 on (B, V) logits under one ``SamplingConfig`` for
    every row. Returns penalized logits (f32)."""
    z = logits.float()
    if cfg.repetition_penalty != 1.0:
        seen = state.prompt_mask | state.output_mask
        f = 1.0 + (cfg.repetition_penalty - 1.0) * seen.float()
        # paper form Z/f for positive logits; standard extension multiplies
        # negative logits so the penalty always reduces probability
        z = torch.where(z > 0, z / f, z * f)
    if cfg.presence_penalty != 0.0:
        z = z - cfg.presence_penalty * state.output_mask.float()
    if cfg.frequency_penalty != 0.0:
        z = z - cfg.frequency_penalty * state.output_counts.float()
    return z


def apply_penalties_rows(logits: torch.Tensor, state: PenaltyState,
                         repetition: torch.Tensor, presence: torch.Tensor,
                         frequency: torch.Tensor) -> torch.Tensor:
    """Vectorized per-row penalty application: all arguments (B,) tensors.

    λ_rep=1 / λ_pres=0 / λ_freq=0 rows are no-ops; no Python branching, so
    one program serves heterogeneous request batches.
    """
    z = logits.float()
    seen = (state.prompt_mask | state.output_mask).float()
    f = 1.0 + (repetition[:, None] - 1.0) * seen
    z = torch.where(z > 0, z / f, z * f)
    z = z - presence[:, None] * state.output_mask.float()
    z = z - frequency[:, None] * state.output_counts.float()
    return z
