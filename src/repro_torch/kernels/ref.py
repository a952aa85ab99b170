"""Plain PyTorch versions of the attention kernels.

They compute what the CUDA kernels compute, in the simplest form: the
whole logits tensor, a finite ``NEG_INF`` mask and a float32 softmax. The
CPU tests hold them against the JAX oracles, `chip_smoke.py` holds each
kernel against them on the card, and `repro_torch.kernels.ops` sends a
CPU tensor here. Layouts are the kernels' own: heads before sequence.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        q_offset: int = 0, scale: float = 1.0):
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D). GQA via head grouping.

    Returns (B, Hq, Sq, D) in q.dtype; softmax in f32.
    """
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, sq, d).float()
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    qi = torch.arange(sq, device=q.device)[:, None] + q_offset
    ki = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (ki <= qi)
    if window > 0:
        mask = mask & (ki > qi - window)
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, v.float())
    return out.reshape(b, hq, sq, d).to(q.dtype)


def decode_attention_ref(q, k, v, valid_len, *, scale: float = 1.0):
    """Single-step decode attention against a (possibly rolling) KV cache.

    q: (B, Hq, D); k, v: (B, Hkv, S, D); valid_len: int, scalar tensor or
    (B,) tensor — the number of valid cache slots per row (slot order is
    irrelevant: keys are stored pre-rotated). A row with ``valid_len == 0``
    gets the uniform mean of its V rows, as the finite mask implies.
    """
    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, d).float()
    logits = torch.einsum("bhgd,bhkd->bhgk", qg, k.float()) * scale
    vl = torch.as_tensor(valid_len, device=q.device).reshape(-1, 1)
    valid = torch.arange(s, device=q.device)[None, :] < vl
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgk,bhkd->bhgd", probs, v.float())
    return out.reshape(b, hq, d).to(q.dtype)
