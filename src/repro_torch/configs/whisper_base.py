"""Whisper-base — encoder-decoder audio transformer; conv frontend is a stub.

[arXiv:2212.04356]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    arch_id="whisper-base",
    family="audio",
    citation="arXiv:2212.04356",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    enc_dec=True,
    n_encoder_layers=6,
    encoder_seq_len=1500,
    activation="geglu",    # whisper uses plain GELU MLP; modeled as gated GELU
    tie_embeddings=True,
))
