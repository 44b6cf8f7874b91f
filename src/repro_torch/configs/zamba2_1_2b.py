"""Zamba2-1.2B — hybrid: Mamba2 backbone + shared attention blocks.

[arXiv:2411.15242] per assignment: 38L d_model=2048 32H (GQA kv=32)
d_ff=8192 vocab=32000, ssm_state=64. Mamba2 blocks with a single
weight-shared attention block applied every ``attn_every`` layers.
"""
from repro_torch.config import HybridConfig, ModelConfig, SSMConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    act="silu",
    ssm=SSMConfig(kind="mamba2", state_size=64, conv_size=4, expand=2),
    hybrid=HybridConfig(attn_every=6, shared_attn=True),
    source="arXiv:2411.15242 (Zamba2-1.2B)",
))
