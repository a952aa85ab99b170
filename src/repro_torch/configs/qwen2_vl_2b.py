"""Qwen2-VL-2B — VLM language backbone with M-RoPE; vision tower is a stub.

[arXiv:2409.12191]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    arch_id="qwen2-vl-2b",
    family="vlm",
    citation="arXiv:2409.12191",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    mrope=True,
    vision_tokens=256,     # stub patch embeddings prepended to the text
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    activation="swiglu",
))
