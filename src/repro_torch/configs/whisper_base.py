"""Whisper-base — encoder-decoder audio model; conv/mel frontend stubbed.

[arXiv:2212.04356] per assignment: 6L d_model=512 8H d_ff=2048 vocab=51865.
Per the carve-out, the mel-spectrogram + conv feature extractor is a STUB:
``input_specs()`` supplies precomputed frame embeddings (B, 1500, 512); the
encoder transformer + decoder (self- and cross-attention) are real.
Whisper uses LayerNorm + GELU and learned positional embeddings; no RoPE.
"""
from repro_torch.config import EncoderConfig, FrontendConfig, ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    act="gelu",
    rope_theta=0.0,              # learned absolute positions instead of RoPE
    tie_embeddings=True,
    encoder=EncoderConfig(num_layers=6, num_frames=1500),
    frontend=FrontendConfig(kind="audio", num_embeddings=1500, embed_dim=512),
    source="arXiv:2212.04356 (Whisper base)",
))
