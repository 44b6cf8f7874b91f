"""Sequence-parallel sampling re-shard (paper §5.1 — mechanism S1).

The LM head leaves each rank a block of the logits: its data rows, and
its V/t slice of the vocabulary where the model axes' size t divides V
(whole rows otherwise). Mainstream engines reconcile the vocabulary axis
(all-gather of B×V) and sample on one replica — the baseline,
``vocab_gather``. SIMPLE instead re-shards to whole rows of B/(dp·t)
sequences a rank: every rank becomes a sampler and NO vocab-axis
collective remains on the critical path.

Bytes a rank receives (t = model axes' size, b = B/dp rows a data block):
  vocab_gather      : all-gather along V      b·V·(t−1)/t
  sequence_parallel : one all-to-all          b·V/t·(t−1)/t — t× less,
and all downstream decision work is embarrassingly parallel along B.

Every function takes the rank's block and returns the rank's block; the
global batch ``B`` and vocabulary ``V`` are passed in, as the block alone
cannot tell a split dimension from a whole one. Without a mesh every
function is the identity.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import dist


def sampler_batch_entry():
    """Batch spec entry for the sequence-parallel decision plane: batch is
    split across EVERY mesh axis (all ranks are samplers)."""
    ctx = dist.get_ctx()
    if not ctx.active:
        return None
    axes = tuple(ctx.batch_axes or ()) + tuple(ctx.model_axes or ())
    return axes if axes else None


def sampler_axes(mode: str):
    """The mesh axes the decision rows are split over in ``mode``."""
    ctx = dist.get_ctx()
    if mode == "sequence_parallel":
        return tuple(ctx.batch_axes or ()) + tuple(ctx.model_axes or ())
    return tuple(ctx.batch_axes or ())


def vocab_split(V: int) -> bool:
    """Whether the LM head leaves V split over the model axes (t > 1
    divides V): each rank then holds V/t columns."""
    ctx = dist.get_ctx()
    tp = ctx.axis_size(ctx.model_axes)
    return ctx.active and tp > 1 and V % tp == 0


def _whole_rows(logits: torch.Tensor, V: int) -> torch.Tensor:
    """The rank's data rows with every column: one all-gather along V
    where the head left V split."""
    ctx = dist.get_ctx()
    if vocab_split(V):
        return dist.all_gather(logits, ctx.model_axes, dim=1, tiled=True)
    return logits


def reshard_for_sampling(logits: torch.Tensor, mode: str, B: int,
                         V: int) -> torch.Tensor:
    """The rank's rows for the decision, whole V, from the block the LM
    head left (``(b, V/t)`` or ``(b, V)``).

    mode == "sequence_parallel": S1 — rows over all axes, V whole. Where
      t > 1, B % dp == 0, b % t == 0 and t divides V this is ONE
      ``all_to_all`` over the model group (the paper's re-shard: each rank
      trades vocabulary slices for whole rows, moving b·V/t instead of
      gathering b·V·(t−1)/t). Otherwise the same rows are taken by
      gather-then-slice (the reference's sharding-constraint branch).
    mode == "vocab_gather": baseline — the data rows, V gathered by ONE
      explicit all-gather, so every downstream reduction sees whole rows
      and the single-device plane's float order (§5.1).
    """
    ctx = dist.get_ctx()
    if not ctx.active:
        return logits
    if mode not in ("sequence_parallel", "vocab_gather"):
        raise ValueError(f"unknown sampling parallelism {mode!r}")
    b_axes = tuple(ctx.batch_axes or ())
    m_axes = tuple(ctx.model_axes or ())
    dp, tp = ctx.axis_size(b_axes), ctx.axis_size(m_axes)
    if mode == "vocab_gather":
        return _whole_rows(logits, V)
    b_loc = B // dp
    if tp > 1 and B % dp == 0 and b_loc % tp == 0 and vocab_split(V):
        # (b, V/t) a rank -> (b/t, V): split rows across the model group,
        # concatenate the vocabulary slices
        return dist.all_to_all(logits, m_axes, split_dim=0, concat_dim=1)
    x = _whole_rows(logits, V)
    d0, nd = dist.rows(B, b_axes)
    s0, ns = dist.rows(B, sampler_axes(mode))
    if not (d0 <= s0 and s0 + ns <= d0 + nd):
        # the rank's sampler rows leave its data block: gather the batch
        x = dist.all_gather(x, b_axes, dim=0, tiled=True)
        d0 = 0
    return x[s0 - d0:s0 - d0 + ns]


def _slice_rows(x, start: int, n: int, B: int):
    if isinstance(x, (torch.Tensor, np.ndarray)) and x.ndim >= 1 \
            and x.shape[0] == B:
        return x[start:start + n]
    return x


def shard_decision_state(tree, mode: str, B: int):
    """The rank's rows, in ``mode``'s layout, of per-sequence decision
    inputs drawn or broadcast for the global batch B (uniforms, sampling
    params, the active mask): every leaf whose leading dim is B is cut to
    the rank's rows; 0-d leaves and None pass through. A NamedTuple comes
    back as one of its type."""
    if not dist.get_ctx().active:
        return tree
    start, n = dist.rows(B, sampler_axes(mode))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_slice_rows(v, start, n, B) for v in tree))
    return _slice_rows(tree, start, n, B)


def gather_tokens(tokens: torch.Tensor, mode: str, B: int) -> torch.Tensor:
    """Tokens of the rank's sampler rows -> tokens of its data rows,
    equal on every model rank: in S1 one all-gather of b/t int32 values
    over the model group."""
    ctx = dist.get_ctx()
    if not ctx.active or mode != "sequence_parallel":
        return tokens
    b_axes = tuple(ctx.batch_axes or ())
    d0, nd = dist.rows(B, b_axes)
    s0, ns = dist.rows(B, sampler_axes(mode))
    if ns == nd:
        return tokens
    if ns == B:              # replicated sampler rows: cut the data block
        return tokens[d0:d0 + nd]
    return dist.all_gather(tokens, ctx.model_axes, dim=0, tiled=True)
