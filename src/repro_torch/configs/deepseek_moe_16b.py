"""DeepSeekMoE-16B — fine-grained MoE: 2 shared + 64 routed experts, top-6.

[arXiv:2401.06066]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    arch_id="deepseek-moe-16b",
    family="moe",
    citation="arXiv:2401.06066",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,            # per-expert fine-grained hidden
    vocab_size=102400,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    activation="swiglu",
))
