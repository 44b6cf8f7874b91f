"""Llama-4 Maverick 400B-A17B — MoE, early fusion.

[hf:meta-llama/Llama-4-Scout-17B-16E] family config per assignment:
48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128 experts top-1,
plus an always-on shared expert (Llama-4 routing style).
"""
from repro_torch.config import ModelConfig, MoEConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    qk_norm=False,
    rope_theta=500000.0,
    act="silu",
    moe=MoEConfig(
        num_experts=128,
        top_k=1,
        d_ff_expert=8192,
        shared_expert_d_ff=8192,
        aux_loss_weight=0.01,
    ),
    source="hf:meta-llama/Llama-4-Scout-17B-16E (assigned: Maverick 400B-A17B)",
))
