"""RWKV-6 "Finch" 3B — attention-free SSM with data-dependent decay.

[arXiv:2404.05892] per assignment: 32L d_model=2560 (attn-free) d_ff=8960
vocab=65536. num_heads below is d_model / rwkv_head_size (64) = 40 wkv heads.
"""
from repro_torch.config import ModelConfig, SSMConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=40,            # wkv heads = d_model / head_size
    num_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65536,
    act="relu_sq",           # rwkv channel-mix uses squared relu
    ssm=SSMConfig(kind="rwkv6", rwkv_head_size=64, decay_lora_rank=64),
    source="arXiv:2404.05892 (RWKV-6 Finch)",
))
