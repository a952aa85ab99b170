"""Flash attention (prefill) on the card: the wrapper of
``csrc/flash_attention.cu``.

On a CUDA tensor it launches the hand-written kernel for its dtype, or
raises: bfloat16 runs the wgmma kernel, float32 the mma.sync kernel whose
products are three TF32 products each (3xTF32), which keeps the f32
tolerance on the tensor cores; `ref.flash_attention_tiled_ref` is that
kernel's order of work on the CPU. On a CPU tensor it runs the plain
version in ``ref.py``. ``flash_attention.launches`` counts the kernel's
launches.

Training goes through `FlashAttentionFn`: its forward is the same call with
the rows' logsumexp written beside the output, its backward the
FlashAttention-2 backward of the JAX package's ``flash_jnp`` (plain code
there, a ``custom_vjp``; plain PyTorch here, `flash_backward`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (
    NEG_INF, attention_mask, flash_attention_lse_ref, flash_attention_ref,
)

# 48, 96 and 192: MLA's qk_nope + qk_rope (reduced, MiniCPM3, DeepSeek-V2)
HEAD_DIMS = (48, 64, 96, 128, 192, 256)
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


def check_last_contiguous(**xs) -> None:
    """Raise unless each tensor's last axis is contiguous: the kernels'
    contract, held on every device so that the plain version on the CPU
    keeps it too."""
    for name, x in xs.items():
        if x.shape[-1] > 1 and x.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous along head_dim, "
                             f"strides {x.stride()}")


def check_aligned(name: str, x: torch.Tensor) -> None:
    """Raise unless ``x`` can be read as 16-byte vectors: its pointer and
    every stride of an axis longer than 1 a multiple of 16 bytes."""
    elem = x.element_size()
    bad = x.data_ptr() % 16
    for st, n in zip(x.stride()[:-1], x.shape[:-1]):
        bad = bad or (n > 1 and (st * elem) % 16)
    if bad:
        raise ValueError(
            f"{name} must be 16-byte aligned for the kernel's vector loads "
            f"(pointer {x.data_ptr():#x}, strides {x.stride()}, "
            f"{elem}-byte elements)")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, scale: float = 1.0,
                    return_lse: bool = False):
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D) -> (B, Hq, Sq, D) in q.dtype,
    and with ``return_lse`` also each row's logsumexp of ``scale * q.k``,
    (B, Hq, Sq) float32.

    Any strides whose last axis is contiguous are taken as they are, so
    views of (B, S, H, D) model tensors need no copy. D must be 48, 64, 96,
    128, 192 or 256 (the bf16 kernel pads 48 and 96 to whole 64-column
    tiles in shared memory, never in device memory) and Hq a multiple of
    Hkv. In
    bfloat16 the kernel copies 16-byte chunks, so pointers and strides must
    be 16-byte aligned; in float32 it copies 16-byte chunks where they are
    and 4-byte ones where not.
    """
    check_last_contiguous(q=q, k=k, v=v)
    if q.device.type in ("cpu", "meta"):
        plain = flash_attention_lse_ref if return_lse else flash_attention_ref
        return plain(q, k, v, causal=causal, window=window,
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
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if q.dtype == torch.bfloat16:
        for name, x in (("q", q), ("k", k), ("v", v), ("out", out)):
            check_aligned(name, x)
    strides = _build.int64_array(
        [s for x in (q, k, v, out) for s in (x.stride(0), x.stride(1),
                                             x.stride(2))])
    lib = _build.load_library()
    err = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), strides,
        b, hq, hkv, sq, sk, d, int(causal), int(window), int(q_offset),
        float(scale), DTYPES[q.dtype], _build.raw_stream(q.device))
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0

# the backward's query and key blocks, as `flash_jnp`'s default
BWD_BLOCK = 512


def flash_backward(q, k, v, lse, dout, *, causal: bool, window: int,
                   q_offset: int, scale: float):
    """The FlashAttention-2 backward (the JAX package's `_flash_bwd_rule`):
    the probabilities are recomputed block by block from (q, k, lse), and
    dq, dk, dv are summed in float32.

    One departure: ``delta_i = sum_j p_ij dp_ij`` is summed from the
    recomputed blocks, where the JAX rule takes ``rowsum(dout * out)``. The
    two are equal in exact arithmetic, but ``out`` has been rounded to the
    inputs' dtype: in bfloat16 that rounding moves delta by up to ~0.1% of
    its size and the first rows' dq and dk by ~5%. Where a query block sees
    one key block this costs nothing (p and dp are at hand); over several it
    costs a second pass of two products.

    Head-major layout as `flash_attention`; lse (B, Hq, Sq) float32. Any Sq
    and Sk: the last block of each is cut short (the JAX rule asserts that
    the blocks divide them). Blocks that no query of the block may see
    (past the causal edge, before the window) are skipped: their
    probabilities are exactly 0. Returns (dq, dk, dv) in the inputs'
    dtypes."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, sq, d).float()
    dog = dout.reshape(b, hkv, g, sq, d).float()
    lseg = lse.reshape(b, hkv, g, sq)
    kf, vf = k.float(), v.float()
    dq = torch.zeros_like(qg)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    pos = torch.arange(max(sq + q_offset, sk), device=q.device)
    block = BWD_BLOCK
    for q0 in range(0, sq, block):
        q1 = min(q0 + block, sq)
        k_lo = max(0, q0 + q_offset - window + 1) if window > 0 else 0
        k_hi = min(sk, q1 + q_offset) if causal else sk
        qb, dob = qg[..., q0:q1, :], dog[..., q0:q1, :]
        spans = [(k0, min(k0 + block, sk)) for k0 in range(0, sk, block)
                 if k0 < k_hi and min(k0 + block, sk) > k_lo]

        def probs(k0, k1):
            """p and dp of this query block against keys [k0, k1)."""
            mask = attention_mask(pos[q0:q1] + q_offset, pos[k0:k1],
                                  causal=causal, window=window)
            s = torch.einsum("bhgqd,bhkd->bhgqk", qb, kf[:, :, k0:k1]) * scale
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            p = torch.exp(s - lseg[..., q0:q1, None])
            dp = torch.einsum("bhgqd,bhkd->bhgqk", dob, vf[:, :, k0:k1])
            return p, dp

        if len(spans) == 1:
            blocks = [probs(*spans[0])]
            delta = (blocks[0][0] * blocks[0][1]).sum(-1)
        else:   # a first pass for delta; the blocks are recomputed below
            blocks = None
            delta = sum((p * dp).sum(-1)
                        for p, dp in (probs(*span) for span in spans))
        for i, (k0, k1) in enumerate(spans):
            p, dp = blocks[i] if blocks else probs(k0, k1)
            dv[:, :, k0:k1] += torch.einsum("bhgqk,bhgqd->bhkd", p, dob)
            ds = p * (dp - delta[..., None]) * scale
            dq[..., q0:q1, :] += torch.einsum("bhgqk,bhkd->bhgqd", ds,
                                              kf[:, :, k0:k1])
            dk[:, :, k0:k1] += torch.einsum("bhgqk,bhgqd->bhkd", ds, qb)
    return (dq.reshape(b, hq, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with a gradient, in `flash_attention`'s layout.

    Forward: the kernel on the card (counted in ``flash_attention.launches``)
    writing the rows' logsumexp, the plain version on the CPU. Backward:
    `flash_backward` from the saved (q, k, v, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, q_offset: int,
                scale: float):
        out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, scale=scale,
                                   return_lse=True)
        ctx.save_for_backward(q, k, v, lse)
        ctx.mask = (causal, window, q_offset, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lse = ctx.saved_tensors
        causal, window, q_offset, scale = ctx.mask
        dq, dk, dv = flash_backward(q, k, v, lse, dout, causal=causal,
                                    window=window, q_offset=q_offset,
                                    scale=scale)
        return dq, dk, dv, None, None, None, None


def tensor_core_selftest(q, k, v):
    """One tile of the bf16 kernel's tensor-core path on the card, through
    its own loaders, swizzle, descriptors and wgmma calls.

    q, k, v: (64, D) bfloat16 on the card, D in HEAD_DIMS. Returns (s, o):
    s = q.kᵀ (64, 64) and o = bf16(s).v (64, D), both float32, for a
    comparison with plain matrix products. Counts no launch.
    """
    d = q.shape[1]
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.shape != (64, d) or x.dtype != torch.bfloat16 \
                or x.device.type != "cuda" or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous (64, {d}) bfloat16 "
                             f"tensor on the card, got {tuple(x.shape)} "
                             f"{x.dtype} on {x.device}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    s = torch.empty(64, 64, dtype=torch.float32, device=q.device)
    o = torch.empty(64, d, dtype=torch.float32, device=q.device)
    err = _build.load_library().repro_flash_selftest(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), s.data_ptr(), o.data_ptr(),
        d, _build.raw_stream(q.device))
    if err != 0:
        raise RuntimeError(f"the tensor-core self-test failed to launch: CUDA "
                           f"error {err}")
    return s, o
