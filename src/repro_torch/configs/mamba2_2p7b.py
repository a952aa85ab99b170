"""Mamba2-2.7B — attention-free SSM with SSD (state-space duality).

[arXiv:2405.21060]
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    arch_id="mamba2-2.7b",
    family="ssm",
    citation="arXiv:2405.21060",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                  chunk_size=256),
))
