"""Family ``granite_hybrid``: Granite 4.0-H (``granitemoehybrid``), a
typed stack of Mamba2 and NoPE attention layers, each followed by a MoE
with a shared expert, and Granite's multipliers; served by the program
as its family "hybrid_moe" (``repro_torch.config.HybridMoEConfig``). The
seam into the program (``model_config``) and the seeded weights' layout
(``leaves``); its plain reference is ``reference/granite_hybrid.py``."""
from __future__ import annotations

import math

from perfbench.harness.program import model_kwargs
from perfbench.harness.weights import base, lin, ones


#: the Mamba2 settings the program's mixer computes, key: value
SERVED = {"mamba_n_groups": 1, "mamba_conv_bias": True,
          "mamba_proj_bias": False}


def model_config(cfg: dict):
    """``repro_torch.config.HybridMoEConfig`` of a configuration file:
    NoPE is ``rope_theta`` 0, and attention's head size is d / heads.
    Refuses a Mamba2 the program's mixer does not compute (``SERVED``;
    heads that do not tile the inner width)."""
    from repro_torch.config import HybridMoEConfig, MoEConfig, SSMConfig
    d, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    for key, one in SERVED.items():
        if cfg[key] != one:
            raise ValueError(f"{key} {cfg[key]!r}: the program serves "
                             f"only {one!r}")
    if cfg["mamba_n_heads"] * cfg["mamba_d_head"] != \
            cfg["mamba_expand"] * d:
        raise ValueError("Mamba2's heads must tile its inner width")
    return HybridMoEConfig(
        family="hybrid_moe", **model_kwargs(cfg),
        num_heads=nh, num_kv_heads=cfg["num_key_value_heads"],
        head_dim=d // nh, rope_theta=0.0, act=cfg["hidden_act"],
        moe=MoEConfig(num_experts=cfg["num_local_experts"],
                      top_k=cfg["num_experts_per_tok"],
                      d_ff_expert=cfg["intermediate_size"],
                      shared_expert_d_ff=cfg["shared_intermediate_size"],
                      capacity_factor=cfg["capacity_factor"]),
        ssm=SSMConfig(kind="mamba2", state_size=cfg["mamba_d_state"],
                      conv_size=cfg["mamba_d_conv"],
                      expand=cfg["mamba_expand"]),
        layer_types=tuple(cfg["layer_types"]),
        mamba_head_dim=cfg["mamba_d_head"],
        embedding_multiplier=cfg["embedding_multiplier"],
        attention_multiplier=cfg["attention_multiplier"],
        residual_multiplier=cfg["residual_multiplier"],
        logits_scaling=cfg["logits_scaling"])


def leaves(cfg: dict) -> list:
    """The embedding and norms; the M Mamba2 mixers (in_proj, conv taps
    and bias, A_log, D, dt_bias, the gated norm, out_proj), the A
    attention mixers (q, k, v, o), then every layer's float32 router,
    experts and shared expert. A_log and dt_bias are normal in log space
    (``init.a_log`` / ``init.dt_bias``: mean, scale), D is ones."""
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    kinds = cfg["layer_types"]
    M, A = kinds.count("mamba"), kinds.count("attention")
    ini = cfg["init"]
    res = ini["residual_out_scale"]
    inner, N = cfg["mamba_expand"] * d, cfg["mamba_d_state"]
    H, K, C = cfg["mamba_n_heads"], cfg["mamba_d_conv"], inner + 2 * N
    nh, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // nh
    E, fe = cfg["num_local_experts"], cfg["intermediate_size"]
    fs = cfg["shared_intermediate_size"]
    mb, at, m = ("stack", "mamba"), ("stack", "attn"), ("stack", "moe")
    sh = m + ("shared",)
    f32 = lambda path, shape, mean, scale: (
        path, shape, "normal", mean, scale, "float32")
    return base(cfg) + [
        lin(mb + ("in_proj",), M, d, 2 * inner + 2 * N + H),
        lin(mb + ("conv_w",), M, K, C),
        (mb + ("conv_b",), (M, C), "normal", 0.0, 1.0 / math.sqrt(K),
         "model"),
        f32(mb + ("A_log",), (M, H), *ini["a_log"]),
        (mb + ("D",), (M, H), "ones", 0.0, 0.0, "float32"),
        f32(mb + ("dt_bias",), (M, H), *ini["dt_bias"]),
        ones(mb + ("norm_w",), (M, inner)),
        lin(mb + ("out_proj",), M, inner, d, res / math.sqrt(inner)),
        lin(at + ("w_q",), A, d, nh * hd),
        lin(at + ("w_k",), A, d, nkv * hd),
        lin(at + ("w_v",), A, d, nkv * hd),
        lin(at + ("w_o",), A, nh * hd, d, res / math.sqrt(nh * hd)),
        (m + ("router",), (L, d, E), "normal", 0.0, 1.0 / math.sqrt(d),
         "float32"),
        (m + ("w_gate",), (L, E, d, fe), "normal", 0.0, 1.0 / math.sqrt(d),
         "model"),
        (m + ("w_up",), (L, E, d, fe), "normal", 0.0, 1.0 / math.sqrt(d),
         "model"),
        (m + ("w_down",), (L, E, fe, d), "normal", 0.0,
         res / math.sqrt(fe), "model"),
        lin(sh + ("w_gate",), L, d, fs),
        lin(sh + ("w_up",), L, d, fs),
        lin(sh + ("w_down",), L, fs, d, res / math.sqrt(fs))]
