"""Decode attention on the card: the wrapper of ``csrc/decode_attention.cu``.

On a CUDA tensor it launches the hand-written kernel, or raises; on a CPU
tensor it runs the plain version in ``ref.py``. ``decode_attention.launches``
counts the kernel's launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import DTYPES, HEAD_DIMS, check_operand
from repro_torch.kernels.ref import decode_attention_ref

MAX_GROUP = 8     # q-heads per kv-head that one CTA holds in registers


def decode_attention(q, k, v, valid_len, *, scale: float = 1.0):
    """q: (B, Hq, D); k, v: (B, Hkv, S, D); valid_len: int or (B,) int.

    Returns (B, Hq, D) in q.dtype. Row b attends to cache slots
    ``[0, valid_len[b])``; a row with valid_len 0 gets the uniform mean of
    its V rows. Any strides whose last axis is contiguous are taken as they
    are (the model passes (B, S, Hkv, D) caches as transposed views).
    """
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, valid_len, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu, not {q.device}")
    b, hq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    hkv, s = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if hq % hkv or hq // hkv > MAX_GROUP:
        raise ValueError(f"q heads {hq} per kv heads {hkv}: the group must "
                         f"divide and be at most {MAX_GROUP}")
    if b == 0 or s == 0:
        raise ValueError("empty attention")
    for name, x in (("q", q), ("k", k), ("v", v)):
        check_operand(name, x, q.dtype, q.device)
    vl = torch.as_tensor(valid_len, device=q.device)
    if vl.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"valid_len must be integer, got {vl.dtype}")
    vl = vl.to(torch.int32).expand(b).contiguous() if vl.ndim == 0 \
        else vl.to(torch.int32).contiguous()
    if vl.shape != (b,):
        raise ValueError(f"valid_len shape {tuple(vl.shape)}, expected ({b},)")
    out = torch.empty_like(q)
    strides = _build.int64_array(
        [q.stride(0), q.stride(1), *k.stride()[:3], *v.stride()[:3],
         out.stride(0), out.stride(1)])
    lib = _build.load_library()
    err = lib.repro_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), vl.data_ptr(),
        out.data_ptr(), strides, b, hq, hkv, s, d, float(scale),
        DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
