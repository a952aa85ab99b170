"""Gemma-2B — dense, GeGLU, head_dim=256, MQA (single KV head).

[arXiv:2403.08295]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    arch_id="gemma-2b",
    family="dense",
    citation="arXiv:2403.08295",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    tie_embeddings=True,
    activation="geglu",
))
