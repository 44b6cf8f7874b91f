"""StarCoder2-7B — dense, GQA + RoPE, GELU MLP.

[arXiv:2402.19173] per assignment: 32L d_model=4608 36H (GQA kv=4)
d_ff=18432 vocab=49152. StarCoder2 uses a plain (non-gated) GELU MLP and
sliding-window attention (4096) in the original model; we keep the window
as the model default.
"""
from repro_torch.config import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="starcoder2-7b",
    family="dense",
    num_layers=32,
    d_model=4608,
    num_heads=36,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab_size=49152,
    rope_theta=100000.0,
    act="gelu",
    sliding_window=4096,
    source="arXiv:2402.19173 (StarCoder2-7B)",
))
