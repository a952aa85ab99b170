"""Mixtral 8x7B — sparse MoE, 8 experts top-2, sliding-window attention.

[arXiv:2401.04088]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    arch_id="mixtral-8x7b",
    family="moe",
    citation="arXiv:2401.04088",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    n_experts=8,
    top_k=2,
    moe_d_ff=14336,
    sliding_window=4096,
    rope_theta=1_000_000.0,
    activation="swiglu",
))
