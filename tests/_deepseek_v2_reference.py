"""A plain forward pass of DeepSeek-V2-Lite's block in float32, for the
tests: nothing of the port (no kernel, no cache, no batching), no JAX, TF32
off. One sequence over its whole length gives the logits of every position.

The block (hf:deepseek-ai/DeepSeek-V2-Lite ``config.json`` and its
``modeling_deepseek.py``), written out from the published description:

* RMSNorm ``x / rms(x) * (1 + scale)`` (the port's parametrisation of the
  published ``weight``; ``scale = weight - 1``).
* MLA without q-LoRA: ``q = h Wq`` split per head into ``nope`` (128) and
  ``rope`` (64) columns; ``[c, k_pe] = h Wkv_a``, ``c`` (512) RMS-normed
  with eps 1e-6 (the published ``kv_a_layernorm``'s default), ``[k_nope,
  v] = c Wkv_b`` per head; the shared ``k_pe`` rotated once and given to
  every head; scores ``q . k`` over the 192 columns times the softmax
  scale, causal, softmax, values, ``Wo``. Expanded per head, not absorbed.
* YaRN rope (`yarn_inv_freq`): blended inverse frequencies, cos and sin
  times ``mscale(f, mscale) / mscale(f, mscale_all_dim)``, the softmax
  scale ``192^-1/2 * mscale(f, mscale_all_dim)^2``. The rotation acts on
  the split halves of the 64 rope columns; the published checkpoint
  rotates interleaved pairs, the same rotation after a fixed permutation
  of those columns of ``Wq`` and ``Wkv_a``, so with drawn weights it is
  the same model (a departure of layout, not of mathematics).
* A SwiGLU MLP in the first ``first_k_dense_replace`` layers; then MoE: a
  float32 softmax router, its top-k probabilities (renormalised only where
  ``norm_topk_prob``; the published ``routed_scaling_factor`` is 1) as the
  routed experts' gates, plus the shared experts' MLP (width ``n_shared *
  moe_intermediate_size``).
* A final RMSNorm and an untied head.

The weights are the port's parameter dict (``embed``, ``layers``,
``final_norm``, ``unembed``; matrices stored (in, out)).
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def no_tf32():
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def correction_range(rs: dict, dim: int, base: float) -> tuple:
    """(low, high) of the published ``yarn_find_correction_range``."""
    orig = rs["original_max_position_embeddings"]

    def slot(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) \
            / (2 * math.log(base))
    low = math.floor(slot(rs["beta_fast"]))
    high = math.ceil(slot(rs["beta_slow"]))
    return max(low, 0), min(high, dim - 1)


def yarn_inv_freq(rs: dict, dim: int, base: float) -> torch.Tensor:
    """``inter * (1 - m) + extra * m``, m = 1 - clamp((i - low) / (high -
    low), 0, 1) over the dim / 2 slots."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    extra = 1.0 / base ** exps
    inter = 1.0 / (rs["factor"] * base ** exps)
    low, high = correction_range(rs, dim, base)
    if low == high:
        high += 0.001
    m = 1.0 - ((torch.arange(dim // 2, dtype=torch.float32) - low)
               / (high - low)).clamp(0, 1)
    return inter * (1 - m) + extra * m


def softmax_scale(cfg: dict) -> float:
    rs = cfg["rope_scaling"]
    qk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    return qk ** -0.5 * mscale(rs["factor"], rs["mscale_all_dim"]) ** 2


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + scale.float())


def rope(x, inv_freq, scale):
    """x (S, H, d) at positions 0..S-1, split halves."""
    ang = torch.arange(x.shape[0], dtype=torch.float32,
                       device=x.device)[:, None] * inv_freq.to(x.device)
    cos = torch.cos(ang)[:, None] * scale
    sin = torch.sin(ang)[:, None] * scale
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def mlp(h, w):
    return (F.silu(h @ w["w_gate"].float()) * (h @ w["w_up"].float())) \
        @ w["w_down"].float()


def attention(h, w, cfg: dict):
    n = h.shape[0]
    nh = cfg["num_attention_heads"]
    dn, dr = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    dv, r = cfg["v_head_dim"], cfg["kv_lora_rank"]
    rs = cfg["rope_scaling"]
    inv = yarn_inv_freq(rs, dr, float(cfg["rope_theta"]))
    cs = mscale(rs["factor"], rs["mscale"]) \
        / mscale(rs["factor"], rs["mscale_all_dim"])
    q = (h @ w["wq"].float()).view(n, nh, dn + dr)
    c, k_pe = (h @ w["wkv_a"].float()).split([r, dr], dim=-1)
    c = rmsnorm(c, w["kv_norm"]["scale"], 1e-6)
    k_nope, v = (c @ w["wkv_b"].float()).view(n, nh, dn + dv).split(
        [dn, dv], dim=-1)
    q = torch.cat([q[..., :dn], rope(q[..., dn:], inv, cs)], dim=-1)
    k_pe = rope(k_pe[:, None, :], inv, cs).expand(n, nh, dr)
    k = torch.cat([k_nope, k_pe], dim=-1)
    s = torch.einsum("qhd,khd->hqk", q, k) * softmax_scale(cfg)
    mask = torch.ones(n, n, dtype=torch.bool, device=h.device).triu(1)
    p = torch.softmax(s.masked_fill(mask, float("-inf")), dim=-1)
    out = torch.einsum("hqk,khd->qhd", p, v).reshape(n, nh * dv)
    return out @ w["wo"].float()


def moe(h, w, cfg: dict):
    probs = torch.softmax(h @ w["router"].float(), dim=-1)
    top, idx = torch.topk(probs, cfg["num_experts_per_tok"], dim=-1)
    if cfg["norm_topk_prob"]:
        top = top / top.sum(-1, keepdim=True)
    out = torch.zeros_like(h)
    for e in range(cfg["n_routed_experts"]):
        rows, slot = (idx == e).nonzero(as_tuple=True)
        if rows.numel():
            ew = {"w_gate": w["we_gate"][e], "w_up": w["we_up"][e],
                  "w_down": w["we_down"][e]}
            out.index_add_(0, rows, mlp(h[rows], ew) * top[rows, slot, None])
    return out + mlp(h, w["shared"])


def logits(weights: dict, cfg: dict, tokens) -> torch.Tensor:
    """(S, V) float32 logits of every position of `tokens` (1-D, on the
    weights' device)."""
    eps = cfg["rms_norm_eps"]
    with no_tf32(), torch.no_grad():
        x = weights["embed"][tokens].float()
        for i, lw in enumerate(weights["layers"]):
            x = x + attention(rmsnorm(x, lw["norm1"]["scale"], eps),
                              lw["mix"], cfg)
            h = rmsnorm(x, lw["norm2"]["scale"], eps)
            x = x + (mlp(h, lw["mlp"])
                     if i < cfg["first_k_dense_replace"]
                     else moe(h, lw["moe"], cfg))
        x = rmsnorm(x, weights["final_norm"]["scale"], eps)
        return x @ weights["unembed"].float().t()
