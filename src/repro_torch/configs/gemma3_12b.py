"""Gemma3-12B — dense, 5:1 local:global attention, 128k context.

[hf:google/gemma-3-1b-pt]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    arch_id="gemma3-12b",
    family="dense",
    citation="hf:google/gemma-3-1b-pt",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    local_global_pattern=(5, 1),
    sliding_window=1024,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    activation="geglu",
    logit_softcap=0.0,
))
