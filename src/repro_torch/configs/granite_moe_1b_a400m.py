"""Granite-3.0 1B-A400M — fine-grained MoE, 32 experts top-8.

[hf:ibm-granite/granite-3.0-1b-a400m-base] per assignment:
24L d_model=1024 16H (GQA kv=8) d_ff=512 vocab=49155, MoE 32e top-8.
"""
from repro_torch.config import ModelConfig, MoEConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    rope_theta=10000.0,
    act="silu",
    tie_embeddings=True,
    moe=MoEConfig(num_experts=32, top_k=8, d_ff_expert=512,
                  aux_loss_weight=0.01),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
))
