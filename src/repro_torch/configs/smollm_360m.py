"""SmolLM-360M — llama-architecture small dense model.

[hf:HuggingFaceTB/SmolLM-135M family] per assignment: 32L d_model=960
15H (GQA kv=5) d_ff=2560 vocab=49152.
"""
from repro_torch.config import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="smollm-360m",
    family="dense",
    num_layers=32,
    d_model=960,
    num_heads=15,
    num_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=49152,
    rope_theta=10000.0,
    act="silu",
    tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-360M",
))
