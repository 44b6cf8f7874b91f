"""Family ``moe``: a decoder of GQA attention (RoPE on every layer) and
a top-k mixture of experts, served by the program as its family "moe".
The seam into the program (``model_config``) and the seeded weights'
layout (``leaves``); its plain reference is ``reference/moe.py``."""
from __future__ import annotations

import math

from perfbench.harness.program import model_kwargs
from perfbench.harness.weights import base, lin


def model_config(cfg: dict):
    """``repro_torch.config.ModelConfig`` of a configuration file."""
    from repro_torch.config import ModelConfig, MoEConfig
    return ModelConfig(
        family="moe", **model_kwargs(cfg),
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
        rope_theta=cfg["rope_theta"], act=cfg["hidden_act"],
        moe=MoEConfig(num_experts=cfg["num_local_experts"],
                      top_k=cfg["num_experts_per_tok"],
                      d_ff_expert=cfg["intermediate_size"],
                      capacity_factor=cfg["capacity_factor"]))


def leaves(cfg: dict) -> list:
    """The embedding and norms, then per layer attention's q, k, v, o,
    the float32 router and the experts' gate, up and down projections."""
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    res = cfg["init"]["residual_out_scale"]
    hd, nh, nkv = (cfg["head_dim"], cfg["num_attention_heads"],
                   cfg["num_key_value_heads"])
    E, fe = cfg["num_local_experts"], cfg["intermediate_size"]
    a, m = ("stack", "attn"), ("stack", "moe")
    return base(cfg) + [
        lin(a + ("w_q",), L, d, nh * hd),
        lin(a + ("w_k",), L, d, nkv * hd),
        lin(a + ("w_v",), L, d, nkv * hd),
        lin(a + ("w_o",), L, nh * hd, d, res / math.sqrt(nh * hd)),
        (m + ("router",), (L, d, E), "normal", 0.0, 1.0 / math.sqrt(d),
         "float32"),
        (m + ("w_gate",), (L, E, d, fe), "normal", 0.0, 1.0 / math.sqrt(d),
         "model"),
        (m + ("w_up",), (L, E, d, fe), "normal", 0.0, 1.0 / math.sqrt(d),
         "model"),
        (m + ("w_down",), (L, E, fe, d), "normal", 0.0,
         res / math.sqrt(fe), "model")]
