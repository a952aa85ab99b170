"""Transformer layers: norms, RoPE, gated MLPs, attention and MLA.

Each is a plain function of (parameter dict, tensors); ``init_*`` builds the
matching dict from a ``torch.Generator``. Attention covers GQA/MQA, sliding
windows and rolling KV caches (keys are cached after rotation, so slot
order does not matter); MLA keeps the compressed latent cache. Cross
attention (the encoder-decoder family) takes its keys and values from the
encoder's output, or from their cache at decode; the encoder's own
attention is bidirectional and unrotated. Prefill, encoder and cross
attention (MLA's prefill included) run on the flash kernel and decode on the
decode kernel when the tensors lie on the card; MLA decode is latent matrix
products, as in the JAX package. With a ``ctx`` that holds a mesh the
attention and the MLP run on this rank's shards (`models/tp.py`, with the
context-parallel decode).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.obs.spans import model_range


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
# RoPE (split-half convention) and M-RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, D); positions: (B, S) integer."""
    return rotate(x, positions, rope_freqs(x.shape[-1], theta, x.device))


def rotate(x, positions, freqs, scale: float = 1.0):
    """x: (B, S, H, D) rotated on its split halves by ``positions`` (B, S)
    times ``freqs`` (D/2,), with cos and sin times ``scale``."""
    ang = positions[..., None].float() * freqs            # (B, S, d/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    if scale != 1.0:
        cos, sin = cos * scale, sin * scale
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# M-RoPE (Qwen2-VL): the head_dim/2 frequency slots are split into temporal,
# height and width sections, each rotated by its own position stream.
MROPE_SECTIONS = (2, 1, 1)   # relative split of the d/2 freq slots (t, h, w)


def apply_mrope(x, positions3, theta: float):
    """x: (B, S, H, D); positions3: (3, B, S) integer (t, h, w)."""
    d = x.shape[-1]
    half = d // 2
    freqs = rope_freqs(d, theta, x.device)                # (half,)
    total = sum(MROPE_SECTIONS)
    bounds = []
    acc = 0
    for s in MROPE_SECTIONS:
        acc += int(round(half * s / total))
        bounds.append(acc)
    bounds[-1] = half
    slot = torch.arange(half, device=x.device)
    sec = (slot >= bounds[0]).long() + (slot >= bounds[1]).long()
    # each frequency slot takes its section's stream: (half, B, S)
    pos = positions3[sec].movedim(0, -1).float()           # (B, S, half)
    ang = pos * freqs
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


def mlp(p, x, activation: str, ctx=None, hidden: int = 0):
    """The gated MLP; under a mesh (``ctx``) on this rank's columns of the
    ``hidden`` units, summed over the model axis."""
    if ctx is not None and ctx.mesh is not None:
        from repro_torch.models import tp as TP
        if not hidden:
            raise ValueError("a sharded mlp needs its whole hidden size")
        return TP.mlp(p, x, activation, ctx, hidden)
    return mlp_hidden(p, x, activation) @ p["w_down"]


def mlp_hidden(p, x, activation: str):
    """The gated MLP's hidden units, act(x @ w_gate) * (x @ w_up)."""
    gate = x @ p["w_gate"]
    up = x @ p["w_up"]
    act = F.gelu(gate, approximate="tanh") if activation == "geglu" \
        else F.silu(gate)
    return act * up


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
    """Causal / windowed / bidirectional attention in the model layout (B,
    S, H, D): the flash kernel on the card, its plain version on the CPU;
    with a gradient where one is wanted (`kernels.ops.flash_attention`)."""
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
        # a meta tensor has no value: any start serves the cost model
        start = 0 if pos.device.type == "meta" \
            else min(max(int(pos), 0), cache_len - s)
        cache_arr[:, start:start + s] = new
        return cache_arr
    start = pos.long().clamp(0, cache_len - s)
    rows = torch.arange(cache_arr.shape[0], device=cache_arr.device)
    for i in range(s):
        cache_arr[rows, start + i] = new[:, i]
    return cache_arr


def attention_layer(p, x, *, cfg: ModelConfig, mode: str, cache=None,
                    pos=None, window: int = 0, positions=None, enc_out=None,
                    enc_cache=None, causal: bool = True, ctx=None,
                    cspec=None):
    """One attention op (no residual/norm).

    mode: "train" | "prefill" | "decode" | "encode". Returns (out, cache').
    The cache tensors are updated in place (JAX builds new arrays): the
    caller's cache dict is the one returned. positions: (B, S), or the (3,
    B, S) M-RoPE streams of a ``cfg.mrope`` model (rotated by
    `apply_mrope`). With ``enc_out`` (B, S_enc, D) or ``enc_cache`` {"k",
    "v"} it is cross attention: queries from x, keys and values from the
    encoder (projected here, or cached), bidirectional and unrotated; it
    returns the keys and values as its cache. RoPE applies only where
    ``causal`` (the encoder's self-attention has none). Under a mesh
    (``ctx``) it runs on this rank's shards (`tp.attention_layer`; ``cspec``
    the cache's k/v spec).
    """
    if ctx is not None and ctx.mesh is not None:
        from repro_torch.models import tp as TP
        return TP.attention_layer(
            p, x, cfg=cfg, ctx=ctx, mode=mode, cache=cache, cspec=cspec,
            pos=pos, window=window, positions=positions, enc_out=enc_out,
            enc_cache=enc_cache, causal=causal)
    ad = attn_dims(cfg)
    b, s, _ = x.shape
    scale = 1.0 / math.sqrt(ad.head_dim)

    q = (x @ p["wq"]).view(b, s, ad.n_heads, ad.head_dim)
    if enc_out is not None or enc_cache is not None:
        if enc_cache is not None:
            k, v = enc_cache["k"], enc_cache["v"]
        else:
            shape = (b, enc_out.shape[1], ad.n_kv_heads, ad.head_dim)
            k = (enc_out @ p["wk"]).view(shape)
            v = (enc_out @ p["wv"]).view(shape)
        out = attn_op(q, k, v, causal=False, window=0, scale=scale)
        out = out.reshape(b, s, ad.n_heads * ad.head_dim) @ p["wo"]
        return out, {"k": k, "v": v}
    k = (x @ p["wk"]).view(b, s, ad.n_kv_heads, ad.head_dim)
    v = (x @ p["wv"]).view(b, s, ad.n_kv_heads, ad.head_dim)

    if positions is None:
        if mode == "decode":
            positions = torch.as_tensor(pos, device=x.device).reshape(-1, 1)
            positions = positions.expand(b, s)
        else:
            positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    if cfg.mrope and positions.ndim == 3:
        q = apply_mrope(q, positions, cfg.rope_theta)
        k = apply_mrope(k, positions, cfg.rope_theta)
    elif causal:  # encoders use their own (or no) positional scheme
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    if mode in ("train", "encode") or (cache is None and mode == "prefill"):
        out = attn_op(q, k, v, causal=causal, window=window, scale=scale)
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


# ---------------------------------------------------------------------------
# MLA: Multi-head Latent Attention (MiniCPM3 / DeepSeek-V2)
# ---------------------------------------------------------------------------


def init_mla(gen, cfg: ModelConfig, device=None):
    """MLA's leaves. ``q_lora_rank`` 0 (DeepSeek-V2-Lite's null) has no
    query latent: one ``wq`` (d, heads * (nope + rope)) and no query
    norm."""
    m = cfg.mla
    d = cfg.d_model
    dt = torch_dtype(cfg.dtype)
    qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
    h = cfg.n_heads
    if m.q_lora_rank:
        p = {"wq_a": dense_init(gen, (d, m.q_lora_rank), dtype=dt,
                                device=device),
             "wq_b": dense_init(gen, (m.q_lora_rank, h * qk_hd), dtype=dt,
                                device=device)}
    else:
        p = {"wq": dense_init(gen, (d, h * qk_hd), dtype=dt, device=device)}
    p.update({
        "wkv_a": dense_init(gen, (d, m.kv_lora_rank + m.qk_rope_head_dim),
                            dtype=dt, device=device),
        "wkv_b": dense_init(gen, (m.kv_lora_rank,
                                  h * (m.qk_nope_head_dim + m.v_head_dim)),
                            dtype=dt, device=device),
        "wo": dense_init(gen, (h * m.v_head_dim, d), dtype=dt, device=device),
    })
    if m.q_lora_rank:
        p["q_norm"] = init_rmsnorm(m.q_lora_rank, device)
    p["kv_norm"] = init_rmsnorm(m.kv_lora_rank, device)
    return p


def init_mla_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
                   device=None):
    """The latent cache: ``ckv`` (B, S, kv_lora_rank) and ``krope`` (B, S,
    qk_rope_head_dim), batch-first as the other caches."""
    m = cfg.mla
    dt = dtype or torch_dtype(cfg.dtype)
    return {"ckv": torch.zeros((batch, max_seq, m.kv_lora_rank), dtype=dt,
                               device=device),
            "krope": torch.zeros((batch, max_seq, m.qk_rope_head_dim),
                                 dtype=dt, device=device)}


def mla_layer(p, x, *, cfg: ModelConfig, mode: str, cache=None, pos=None,
              positions=None, block=None):
    """MLA with the compressed latent cache (per token ``kv_lora_rank +
    qk_rope_head_dim`` values instead of ``2 * H * head_dim``).

    Prefill folds the shared rope key into every head, so attention is the
    flash kernel's at head_dim ``qk_nope + qk_rope`` with V zero-padded to
    that width (as the JAX package pads it). Decode is the weight-absorbed
    latent form in float32: the cache is never expanded to per-head K/V.
    ``block`` (`models.block.Block`) gives a published rotary scaling of
    the rope dims. The cache tensors are updated in place. Returns (out,
    cache')."""
    b, s, _ = x.shape
    positions = mla_positions(x, mode, pos, positions)
    cq, ckv, krope = mla_latents(p, x, cfg=cfg, positions=positions,
                                 block=block)
    wq = p["wq_b"] if cfg.mla.q_lora_rank else p["wq"]
    q_nope, q_rope = mla_queries(cq, wq, cfg=cfg, positions=positions,
                                 block=block)

    new_cache = None
    if mode == "decode":
        if s != 1:
            raise ValueError(f"decode takes one token per row, got {s}")
        update_cache_seq(cache["ckv"], ckv, pos)
        update_cache_seq(cache["krope"], krope, pos)
        new_cache = cache
        out = mla_absorbed_decode(p["wkv_b"], q_nope, q_rope, cache["ckv"],
                                  cache["krope"], pos, cfg=cfg, block=block)
    else:
        if mode == "prefill" and cache is not None:
            cache["ckv"][:, :s] = ckv
            cache["krope"][:, :s] = krope
            new_cache = cache
        out = mla_prefill_attention(p["wkv_b"], q_nope, q_rope, ckv, krope,
                                    cfg=cfg, block=block)
    return out.reshape(b, s, -1) @ p["wo"], new_cache


def mla_positions(x, mode: str, pos, positions):
    """(B, S) positions of an MLA layer's tokens: ``positions`` where given,
    else ``pos`` at decode and 0..S-1 otherwise."""
    if positions is not None:
        return positions
    b, s, _ = x.shape
    if mode == "decode":
        return torch.as_tensor(pos, device=x.device).reshape(-1, 1).expand(
            b, s)
    return torch.arange(s, device=x.device)[None, :].expand(b, s)


def mla_rope(x, positions, cfg: ModelConfig, block=None):
    """The MLA rope dims of x (B, S, H, rope) rotated: plain, or with the
    published rotary scaling of ``block``."""
    scaled = block.rope(x.shape[-1], cfg.rope_theta, x.device) \
        if block is not None else None
    if scaled is None:
        return apply_rope(x, positions, cfg.rope_theta)
    freqs, scale = scaled
    return rotate(x, positions, freqs, scale)


def mla_softmax_scale(cfg: ModelConfig, block=None) -> float:
    """``(nope + rope)^-1/2``, times a rotary scaling's factor."""
    m = cfg.mla
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    return scale if block is None else scale * block.softmax_factor


def mla_latents(p, x, *, cfg: ModelConfig, positions, block=None):
    """(the normed query latent (B, S, q_lora_rank), or x itself without
    q-LoRA; the normed KV latent (B, S, kv_lora_rank); the rotated shared
    rope key (B, S, rope_dim))."""
    m = cfg.mla
    cq = rmsnorm(p["q_norm"], x @ p["wq_a"]) if m.q_lora_rank else x
    ckv, krope = (x @ p["wkv_a"]).split([m.kv_lora_rank,
                                         m.qk_rope_head_dim], dim=-1)
    ckv = rmsnorm(p["kv_norm"], ckv)
    krope = mla_rope(krope[:, :, None, :], positions, cfg, block)[:, :, 0]
    return cq, ckv, krope


def mla_queries(cq, wq_b, *, cfg: ModelConfig, positions, block=None):
    """(q_nope, rotated q_rope), each (B, S, heads, dim), for the heads
    whose columns ``wq_b`` (or without q-LoRA ``wq``) holds."""
    m = cfg.mla
    b, s, _ = cq.shape
    qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
    q = (cq @ wq_b).view(b, s, -1, qk_hd)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    return q_nope, mla_rope(q_rope, positions, cfg, block)


def mla_absorbed_decode(wkv_b, q_nope, q_rope, ckv_cache, krope_cache, pos,
                        *, cfg: ModelConfig, block=None):
    """The weight-absorbed decode in float32 for the heads of ``q_nope``
    (B, 1, heads, nope) and ``wkv_b``'s columns, over whole latent caches
    (B, T, rank) whose slots up to ``pos`` are valid. Returns (B, 1, heads,
    v_head_dim) in the queries' dtype. Ranges: ``model.mla.expand`` (the
    queries absorbed into the latent), ``model.mla.attend``."""
    m = cfg.mla
    dn, dv = m.qk_nope_head_dim, m.v_head_dim
    scale = mla_softmax_scale(cfg, block)
    h = q_nope.shape[2]
    f32 = torch.float32
    with model_range("model.mla.expand"):
        wkv = wkv_b.view(m.kv_lora_rank, h, dn + dv).float()
        q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope.float(), wkv[..., :dn])
    with model_range("model.mla.attend"):
        ckv_f = ckv_cache.to(f32)
        logits = (torch.einsum("bqhr,bkr->bhqk", q_lat, ckv_f)
                  + torch.einsum("bqhd,bkd->bhqk", q_rope.float(),
                                 krope_cache.to(f32))) * scale
        t = ckv_f.shape[1]
        posv = torch.as_tensor(pos, device=q_nope.device).reshape(-1, 1)
        valid = (torch.arange(t, device=q_nope.device)[None, :] <= posv)
        logits = logits.masked_fill(~valid[:, None, None, :], -1e30)
        probs = torch.softmax(logits, dim=-1)
        out_lat = torch.einsum("bhqk,bkr->bqhr", probs, ckv_f)
        return torch.einsum("bqhr,rhd->bqhd", out_lat,
                            wkv[..., dn:]).to(q_nope.dtype)


def mla_prefill_attention(wkv_b, q_nope, q_rope, ckv, krope, *,
                          cfg: ModelConfig, block=None):
    """Causal attention of the heads of ``q_nope`` (and ``wkv_b``'s
    columns) over the expanded latent: the flash kernel at head_dim
    ``nope + rope``, V zero-padded to it. Returns (B, S, heads,
    v_head_dim). Ranges: ``model.mla.expand`` (the latent's up-projection
    to per-head keys and values), ``model.mla.attend`` (flash)."""
    m = cfg.mla
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    qk_hd = dn + dr
    b, s, h, _ = q_nope.shape
    with model_range("model.mla.expand"):
        kv_up = (ckv @ wkv_b).view(b, s, h, dn + dv)
        k_nope, v = kv_up.split([dn, dv], dim=-1)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        k_full = torch.cat([k_nope,
                            krope[:, :, None, :].expand(b, s, h, dr)], dim=-1)
        vp = F.pad(v, (0, qk_hd - dv))
    with model_range("model.mla.attend"):
        return attn_op(q_full, k_full, vp, causal=True, window=0,
                       scale=mla_softmax_scale(cfg, block))[..., :dv]
