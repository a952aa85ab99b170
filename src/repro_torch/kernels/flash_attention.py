"""Flash attention (prefill) on the card: the wrapper of
``csrc/flash_attention.cu``.

On a CUDA tensor it launches the hand-written kernel, or raises; on a CPU
tensor it runs the plain version in ``ref.py``. ``flash_attention.launches``
counts the kernel's launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

HEAD_DIMS = (64, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_operand(name: str, x: torch.Tensor, dtype, device) -> None:
    """Raise unless ``x`` is a tensor the kernels take: on ``device``, of
    ``dtype`` (float32 or bfloat16), with a contiguous last axis."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype or dtype not in DTYPES:
        raise TypeError(f"{name} is {x.dtype}; the kernel takes float32 or "
                        f"bfloat16, the same for every operand")
    if x.stride(-1) != 1:
        raise ValueError(f"{name} must be contiguous along head_dim, "
                         f"strides {x.stride()}")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, scale: float = 1.0):
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D) -> (B, Hq, Sq, D) in q.dtype.

    Any strides whose last axis is contiguous are taken as they are, so
    views of (B, S, H, D) model tensors need no copy. D must be 64, 128 or
    256 and Hq a multiple of Hkv.
    """
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    b, hq, sq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    hkv, sk = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    if sq == 0 or sk == 0 or b == 0:
        raise ValueError("empty attention")
    for name, x in (("q", q), ("k", k), ("v", v)):
        check_operand(name, x, q.dtype, q.device)
    out = torch.empty_like(q)       # keeps q's strides
    strides = _build.int64_array(
        [s for x in (q, k, v, out) for s in (x.stride(0), x.stride(1),
                                             x.stride(2))])
    lib = _build.load_library()
    err = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
        b, hq, hkv, sq, sk, d, int(causal), int(window), int(q_offset),
        float(scale), DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
