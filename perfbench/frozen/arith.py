"""The benchmark's own arithmetic of work: model FLOPs per token, the
decision plane's bytes, and the table of peaks, over a configuration
file's sizes; it imports nothing of the program.

The model FLOPs are each family's, in its ``reference/<family>.py``:
they extend ``launch/hlo_analysis.model_flops_estimate`` (2 x active
parameters a token) with what the family adds, such as attention's
score and value products over each token's context or RWKV-6's WKV
recurrence.
"""
from __future__ import annotations

import json
from pathlib import Path

from perfbench.harness import spec

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def peaks(device_name: str) -> dict:
    """The published peaks of the card ``device_name`` names."""
    if device_name not in PEAKS:
        raise KeyError(f"no peaks for {device_name!r} in frozen/peaks.json")
    return PEAKS[device_name]


def _family(cfg: dict):
    return spec.load_family("reference", cfg["family"])


def matmul_params(cfg: dict) -> int:
    """Weights that one token multiplies through (active experts only):
    embedding lookups cost no FLOPs, the LM head does."""
    return _family(cfg).matmul_params(cfg)


def token_flops(cfg: dict, context: int) -> float:
    """FLOPs of one token whose context (itself included) is ``context``
    positions: 2 per multiplied weight, plus the family's own (attention
    over the context, a recurrence's state update)."""
    return _family(cfg).token_flops(cfg, context)


def prompt_flops(cfg: dict, prompt_len: int) -> float:
    """FLOPs of prefilling a prompt of ``prompt_len`` real tokens (its
    padding is waste and is not counted)."""
    return _family(cfg).prompt_flops(cfg, prompt_len)


def decision_bytes(rows: int, vocab: int) -> int:
    """The decision plane's least traffic for ``rows`` rows: one read of
    the (rows, V) float32 logits and one int32 token written a row. The
    same whatever backend or kernel implements the decision."""
    return rows * vocab * 4 + rows * 4

