"""InternVL2-2B — VLM: InternViT vision encoder (stubbed frontend) +
InternLM2 language decoder.

[arXiv:2404.16821] per assignment: 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92553. The ViT + MLP projector frontend is a STUB per the assignment
carve-out: ``input_specs()`` provides 256 precomputed patch embeddings of
shape (B, 256, d_model) that the decoder consumes alongside text tokens.
"""
from repro_torch.config import FrontendConfig, ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,
    rope_theta=1000000.0,
    act="silu",
    frontend=FrontendConfig(kind="vision", num_embeddings=256, embed_dim=2048),
    source="arXiv:2404.16821 (InternVL2-2B; InternViT frontend stubbed)",
))
