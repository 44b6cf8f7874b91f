"""Family ``ssm``: RWKV-6 in the program's form, served by the program
as its family "ssm" with the RWKV-6 recurrence. The seam into the
program (``model_config``) and the seeded weights' layout (``leaves``);
its plain reference is ``reference/ssm.py``."""
from __future__ import annotations

import math

from perfbench.harness.program import model_kwargs
from perfbench.harness.weights import base, lin, ones


def model_config(cfg: dict):
    """``repro_torch.config.ModelConfig`` of a configuration file."""
    from repro_torch.config import ModelConfig, SSMConfig
    d, hs = cfg["hidden_size"], cfg["head_size"]
    return ModelConfig(
        family="ssm", **model_kwargs(cfg),
        num_heads=d // hs, num_kv_heads=d // hs, head_dim=hs, act="relu_sq",
        ssm=SSMConfig(kind="rwkv6", rwkv_head_size=hs,
                      decay_lora_rank=cfg["decay_lora_rank"]))


def leaves(cfg: dict) -> list:
    """The embedding, untied head and norms, then per layer the time
    mix (token-shift mixes, r k v g o, the decay's base and LoRA, the
    bonus u, the group norm) and the channel mix."""
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    res = cfg["init"]["residual_out_scale"]
    r, f = cfg["decay_lora_rank"], cfg["intermediate_size"]
    p = ("stack", "layers")
    vec = lambda name, shape, mean, noise: (
        p + (name,), (L,) + shape, "normal", mean, noise, "model")
    return base(cfg) + [vec("mu", (5, d), 0.5, 0.1)] + [
        lin(p + (w,), L, d, d) for w in ("w_r", "w_k", "w_v", "w_g")] + [
        lin(p + ("w_o",), L, d, d, res / math.sqrt(d)),
        vec("w0", (d,), -6.0, 0.3),
        lin(p + ("lora_a",), L, d, r, 0.01),
        lin(p + ("lora_b",), L, r, d, 0.01),
        vec("u", (d,), 0.0, 0.3),
        ones(p + ("ln_x",), (L, d)),
        vec("mu_c", (2, d), 0.5, 0.1),
        lin(p + ("w_ck",), L, d, f),
        lin(p + ("w_cv",), L, f, d, res / math.sqrt(f)),
        lin(p + ("w_cr",), L, d, d)]
