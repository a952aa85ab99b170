"""The paper's own deployment models (PerLLM §4.1).

Edge: Yi-6B, LLaMA2-7B, LLaMA3-8B, Yi-9B. Cloud: LLaMA2-33B.
These drive the edge-cloud cluster cost model in `repro_torch.cluster`.
"""
from repro_torch.configs.base import ModelConfig, register

YI_6B = register(ModelConfig(
    arch_id="yi-6b", family="dense", citation="hf:01-ai/Yi-6B",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=11008, vocab_size=64000, activation="swiglu",
))

LLAMA2_7B = register(ModelConfig(
    arch_id="llama2-7b", family="dense", citation="arXiv:2307.09288",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
    d_ff=11008, vocab_size=32000, activation="swiglu",
))

LLAMA3_8B = register(ModelConfig(
    arch_id="llama3-8b", family="dense", citation="hf:meta-llama/Meta-Llama-3-8B",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=128256, rope_theta=500_000.0, activation="swiglu",
))

YI_9B = register(ModelConfig(
    arch_id="yi-9b", family="dense", citation="hf:01-ai/Yi-9B",
    n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=11008, vocab_size=64000, activation="swiglu",
))

LLAMA2_33B = register(ModelConfig(
    arch_id="llama2-33b", family="dense", citation="arXiv:2307.09288",
    n_layers=60, d_model=6656, n_heads=52, n_kv_heads=52, head_dim=128,
    d_ff=17920, vocab_size=32000, activation="swiglu",
))

EDGE_MODELS = ("yi-6b", "llama2-7b", "llama3-8b", "yi-9b")
CLOUD_MODEL = "llama2-33b"
