"""RecurrentGemma-2B (Griffin) — RG-LRU recurrent blocks + local attention, 1:2.

[arXiv:2402.19427]
"""
from repro_torch.configs.base import ModelConfig, RGLRUConfig, register

CONFIG = register(ModelConfig(
    arch_id="recurrentgemma-2b",
    family="hybrid",
    citation="arXiv:2402.19427",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    sliding_window=2048,
    rglru=RGLRUConfig(d_rnn=2560, d_conv=4,
                      block_pattern=("rec", "rec", "attn")),
    tie_embeddings=True,
    activation="geglu",
))
