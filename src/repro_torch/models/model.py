"""Public model API: init / forward / prefill / decode, per config.

Parameters are a plain dict: ``embed`` (V, D), ``layers`` (one dict per
layer, in execution order), ``final_norm`` and, for untied models,
``unembed``. ``init_params`` draws from a seeded ``torch.Generator`` with the
JAX package's distributions and scales (not its bits: ``convert.py`` carries
JAX weights over when the two must agree).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.parallel import resolve_device

# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, seed: int = 0, device=None):
    """Random weights for `cfg` on `device` (CUDA unless named)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = L.torch_dtype(cfg.dtype)
    params = {
        "embed": L.dense_init(gen, (cfg.vocab_size, cfg.d_model), scale=0.02,
                              dtype=dt, device=dev),
        "layers": T.init_stack(gen, cfg, dev),
        "final_norm": L.init_rmsnorm(cfg.d_model, dev),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = L.dense_init(
            gen, (cfg.vocab_size, cfg.d_model),
            scale=1.0 / math.sqrt(cfg.d_model), dtype=dt, device=dev)
    return params


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def embed_tokens(params, tokens, cfg: ModelConfig):
    x = params["embed"][tokens]
    if cfg.family in ("dense", "hybrid", "vlm") and cfg.tie_embeddings:
        # gemma-family convention: scale token embeddings by sqrt(d), in the
        # embedding's own dtype
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def lm_head(params, x, cfg: ModelConfig):
    """Logits in float32, with the optional tanh softcap."""
    w = params["embed"] if cfg.tie_embeddings else params["unembed"]
    logits = x.float() @ w.float().t()
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def forward(params, batch, *, cfg: ModelConfig, mode: str = "train",
            cache=None, pos=None):
    """batch: {"tokens": (B, S) integer [, "positions": (B, S)]}.

    Returns (logits (B, S, V) float32, cache'). The cache is updated in
    place."""
    x = embed_tokens(params, batch["tokens"], cfg)
    x, new_cache = T.run_stack(params["layers"], x, cfg=cfg, mode=mode,
                               cache=cache, pos=pos,
                               positions=batch.get("positions"))
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return lm_head(params, x, cfg), new_cache


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device=None):
    """Per-layer {"k", "v"} caches of (batch, slots, Hkv, D)."""
    return T.init_stack_cache(cfg, batch, max_seq, dtype=dtype,
                              device=resolve_device(device))


def prefill(params, batch, cache, *, cfg: ModelConfig):
    """Run the prompt through the stack and fill the cache.

    Returns (last_token_logits (B, V), cache')."""
    logits, new_cache = forward(params, batch, cfg=cfg, mode="prefill",
                                cache=cache)
    return logits[:, -1], new_cache


def decode_step(params, tokens, cache, pos, *, cfg: ModelConfig):
    """One decode step. tokens: (B, 1); pos: int or (B,) current positions.

    Returns (logits (B, V), cache')."""
    logits, new_cache = forward(params, {"tokens": tokens}, cfg=cfg,
                                mode="decode", cache=cache, pos=pos)
    return logits[:, -1], new_cache

