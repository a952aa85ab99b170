"""Transformer layers of the dense family: norms, RoPE, gated MLPs, attention.

Each is a plain function of (parameter dict, tensors); ``init_*`` builds the
matching dict from a ``torch.Generator``. Attention covers GQA/MQA, sliding
windows and rolling KV caches (keys are cached after rotation, so slot
order does not matter). Prefill attention runs on the flash kernel and
decode on the decode kernel when the tensors lie on the card. MLA, M-RoPE,
cross attention and context-parallel decode are not ported yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def dense_init(gen: torch.Generator, shape, scale: Optional[float] = None,
               dtype=torch.bfloat16, device=None):
    """Normal(0, 1) * scale, with scale 1/sqrt(fan_in) by default."""
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * scale).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def init_rmsnorm(d: int, device=None):
    return {"scale": torch.zeros((d,), dtype=torch.float32, device=device)}


def rmsnorm(p, x, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + p["scale"])).to(dt)


# ---------------------------------------------------------------------------
# RoPE (split-half convention)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, D); positions: (B, S) integer."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                # (d/2,)
    ang = positions[..., None].float() * freqs            # (B, S, d/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------


def init_mlp(gen, d: int, hidden: int, dtype, device=None):
    return {
        "w_gate": dense_init(gen, (d, hidden), dtype=dtype, device=device),
        "w_up": dense_init(gen, (d, hidden), dtype=dtype, device=device),
        "w_down": dense_init(gen, (hidden, d), dtype=dtype, device=device),
    }


def mlp(p, x, activation: str):
    gate = x @ p["w_gate"]
    up = x @ p["w_up"]
    act = F.gelu(gate, approximate="tanh") if activation == "geglu" \
        else F.silu(gate)
    return (act * up) @ p["w_down"]


# ---------------------------------------------------------------------------
# Attention (GQA / MQA, full / sliding window)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnDims:
    n_heads: int
    n_kv_heads: int
    head_dim: int


def attn_dims(cfg: ModelConfig) -> AttnDims:
    return AttnDims(cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim)


def init_attention(gen, cfg: ModelConfig, device=None):
    d = cfg.d_model
    ad = attn_dims(cfg)
    dt = torch_dtype(cfg.dtype)
    hq, hkv = ad.n_heads * ad.head_dim, ad.n_kv_heads * ad.head_dim
    return {
        "wq": dense_init(gen, (d, hq), dtype=dt, device=device),
        "wk": dense_init(gen, (d, hkv), dtype=dt, device=device),
        "wv": dense_init(gen, (d, hkv), dtype=dt, device=device),
        "wo": dense_init(gen, (hq, d), scale=1.0 / math.sqrt(hq), dtype=dt,
                         device=device),
    }


def attn_op(q, k, v, *, causal: bool, window: int, scale: float,
            q_offset: int = 0):
    """Causal / windowed attention in the model layout (B, S, H, D): the
    flash kernel on the card, its plain version on the CPU."""
    return kops.flash_attention(q, k, v, causal=causal, window=window,
                                q_offset=q_offset, scale=scale)


def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int,
                  window: int = 0, dtype=None, device=None):
    ad = attn_dims(cfg)
    s = min(window, max_seq) if window else max_seq
    dt = dtype or torch_dtype(cfg.dtype)
    shape = (batch, s, ad.n_kv_heads, ad.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def update_cache_seq(cache_arr, new, pos):
    """Write `new` (B, s, ...) into `cache_arr` (B, S, ...) at seq offset
    `pos`: an int or scalar tensor (aligned batch) or a (B,) tensor
    (continuous batching). The start is clamped so the write fits, as in
    the JAX package. Writes in place and returns `cache_arr`."""
    s, cache_len = new.shape[1], cache_arr.shape[1]
    pos = torch.as_tensor(pos, device=cache_arr.device)
    if pos.ndim == 0:
        start = min(max(int(pos), 0), cache_len - s)
        cache_arr[:, start:start + s] = new
        return cache_arr
    start = pos.long().clamp(0, cache_len - s)
    rows = torch.arange(cache_arr.shape[0], device=cache_arr.device)
    for i in range(s):
        cache_arr[rows, start + i] = new[:, i]
    return cache_arr


def attention_layer(p, x, *, cfg: ModelConfig, mode: str, cache=None,
                    pos=None, window: int = 0, positions=None):
    """One attention op (no residual/norm).

    mode: "train" | "prefill" | "decode". Returns (out, cache'). The cache
    tensors are updated in place (JAX builds new arrays): the caller's cache
    dict is the one returned.
    """
    ad = attn_dims(cfg)
    b, s, _ = x.shape
    scale = 1.0 / math.sqrt(ad.head_dim)

    q = (x @ p["wq"]).view(b, s, ad.n_heads, ad.head_dim)
    k = (x @ p["wk"]).view(b, s, ad.n_kv_heads, ad.head_dim)
    v = (x @ p["wv"]).view(b, s, ad.n_kv_heads, ad.head_dim)

    if positions is None:
        if mode == "decode":
            positions = torch.as_tensor(pos, device=x.device).reshape(-1, 1)
            positions = positions.expand(b, s)
        else:
            positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    if mode == "train" or (cache is None and mode == "prefill"):
        out = attn_op(q, k, v, causal=True, window=window, scale=scale)
    elif mode == "prefill":
        out = attn_op(q, k, v, causal=True, window=window, scale=scale)
        cache_len = cache["k"].shape[1]
        if cache_len >= s:
            cache["k"][:, :s] = k
            cache["v"][:, :s] = v
        else:  # rolling window smaller than the prompt: keep the last slots
            if s % cache_len:
                raise ValueError(f"window {cache_len} must divide the "
                                 f"prefill length {s}")
            cache["k"].copy_(k[:, s - cache_len:])
            cache["v"].copy_(v[:, s - cache_len:])
        new_cache = cache
    elif mode == "decode":
        if s != 1:
            raise ValueError(f"decode takes one token per row, got {s}")
        cache_len = cache["k"].shape[1]
        pos = torch.as_tensor(pos, device=x.device)
        rolling = bool(window) and window <= cache_len
        slot = pos % window if rolling else pos
        update_cache_seq(cache["k"], k, slot)
        update_cache_seq(cache["v"], v, slot)
        new_cache = cache
        valid_len = torch.clamp(pos + 1, max=window) if rolling else pos + 1
        out = kops.decode_attention(q, cache["k"], cache["v"],
                                    valid_len.to(torch.int32), scale=scale)
    else:
        raise ValueError(mode)

    out = out.reshape(b, s, ad.n_heads * ad.head_dim) @ p["wo"]
    return out, new_cache
