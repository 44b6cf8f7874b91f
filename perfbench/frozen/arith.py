"""The benchmark's own arithmetic of work: model FLOPs per token, the
decision plane's bytes, and the table of peaks. Plain Python over a
configuration file's sizes; it imports nothing of the program.

The model FLOPs extend ``launch/hlo_analysis.model_flops_estimate``
(2 x active parameters a token) with attention's score and value
products over each token's context and RWKV-6's WKV recurrence.
"""
from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def peaks(device_name: str) -> dict:
    """The published peaks of the card ``device_name`` names."""
    if device_name not in PEAKS:
        raise KeyError(f"no peaks for {device_name!r} in frozen/peaks.json")
    return PEAKS[device_name]


def matmul_params(cfg: dict) -> int:
    """Weights that one token multiplies through (active experts only):
    embedding lookups cost no FLOPs, the LM head does."""
    d, V, L = cfg["hidden_size"], cfg["vocab_size"], cfg["num_hidden_layers"]
    if cfg["family"] == "ssm":
        r, f = cfg["decay_lora_rank"], cfg["intermediate_size"]
        # w_r, w_k, w_v, w_g, w_o; the decay LoRA; w_ck, w_cv, w_cr
        layer = 5 * d * d + 2 * d * r + 2 * d * f + d * d
    else:
        hd = cfg["head_dim"]
        nh, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
        attn = d * nh * hd + 2 * d * nkv * hd + nh * hd * d
        if cfg.get("num_local_experts"):
            E, k = cfg["num_local_experts"], cfg["num_experts_per_tok"]
            ffn = k * 3 * d * cfg["intermediate_size"] + d * E
        else:
            ffn = 3 * d * cfg["intermediate_size"]
        layer = attn + ffn
    return L * layer + d * V


def token_flops(cfg: dict, context: int) -> float:
    """FLOPs of one token whose context (itself included) is ``context``
    positions: 2 per multiplied weight, plus per attention layer 4 x heads
    x head size x context (scores and the weighted sum), plus per RWKV-6
    layer ~6 x d x head size for the WKV state update and read."""
    f = 2.0 * matmul_params(cfg)
    L = cfg["num_hidden_layers"]
    if cfg["family"] == "ssm":
        f += L * 6.0 * cfg["hidden_size"] * cfg["head_size"]
    else:
        f += L * 4.0 * cfg["num_attention_heads"] * cfg["head_dim"] * context
    return f


def prompt_flops(cfg: dict, prompt_len: int) -> float:
    """FLOPs of prefilling a prompt of ``prompt_len`` real tokens (its
    padding is waste and is not counted)."""
    if cfg["family"] == "ssm":
        return prompt_len * token_flops(cfg, 0)
    # token c (1-based) attends over c positions: sum_c c = n (n + 1) / 2
    return (2.0 * matmul_params(cfg) * prompt_len
            + cfg["num_hidden_layers"] * 4.0 * cfg["num_attention_heads"]
            * cfg["head_dim"] * prompt_len * (prompt_len + 1) / 2)


def decision_bytes(rows: int, vocab: int) -> int:
    """The decision plane's least traffic for ``rows`` rows: one read of
    the (rows, V) float32 logits and one int32 token written a row. The
    same whatever backend or kernel implements the decision."""
    return rows * vocab * 4 + rows * 4

