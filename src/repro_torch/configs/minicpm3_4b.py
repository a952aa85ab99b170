"""MiniCPM3-4B — dense with Multi-head Latent Attention (MLA).

[hf:openbmb/MiniCPM3-4B]
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    arch_id="minicpm3-4b",
    family="dense",
    citation="hf:openbmb/MiniCPM3-4B",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    head_dim=64,
    d_ff=6400,
    vocab_size=73448,
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256,
                  qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64),
    tie_embeddings=True,
    activation="swiglu",
))
