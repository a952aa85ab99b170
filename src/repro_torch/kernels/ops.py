"""Model-layout entry points of the kernels.

The attention ones take the model's (B, S, H, D) tensors (and
(n_pool, page, Hkv, D) page pools) and hand the kernels head-major views of
them, with no copy; the SSD one takes the model's (B, S, H, P) as it is. The device picks the path: a CPU
tensor runs the plain version, a CUDA tensor the hand-written kernel, which
launches or raises. ``force_kernel=True`` on a CPU tensor raises, as the
JAX package's ``_auto_interpret`` does when the Pallas lowering is forced
where it cannot run.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _paged
from repro_torch.kernels import ssd_diag as _ssd


def _check_kernel_device(x, force_kernel: bool) -> None:
    if force_kernel and x.device.type != "cuda":
        raise RuntimeError(
            f"the CUDA kernel was forced on a {x.device.type} tensor; the "
            f"kernels run only on the card (leave force_kernel=False to take "
            f"the plain version on the CPU)")


def _needs_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, scale: float = 1.0,
                    force_kernel: bool = False):
    """q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D) -> (B, Sq, Hq, D). Where a
    gradient is wanted it goes through `FlashAttentionFn` (the same kernel
    launch, with the logsumexp saved for the backward)."""
    _check_kernel_device(q, force_kernel)
    args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    if _needs_grad(q, k, v):
        out = _fa.FlashAttentionFn.apply(*args, causal, window, q_offset,
                                         scale)
    else:
        out = _fa.flash_attention(*args, causal=causal, window=window,
                                  q_offset=q_offset, scale=scale)
    return out.transpose(1, 2)


def decode_attention(q, k, v, valid_len, *, scale: float = 1.0,
                     force_kernel: bool = False, return_lse: bool = False):
    """q: (B, 1, Hq, D) or (B, Hq, D); k, v: (B, S, Hkv, D);
    valid_len: int or (B,) valid cache slots per row. With ``return_lse``
    also each row's logsumexp, (B, Hq) float32."""
    _check_kernel_device(q, force_kernel)
    squeeze = q.ndim == 4
    if squeeze:
        q = q[:, 0]
    out = _dec.decode_attention(q, k.transpose(1, 2), v.transpose(1, 2),
                                valid_len, scale=scale,
                                return_lse=return_lse)
    if return_lse:
        out, lse = out
        return (out[:, None] if squeeze else out), lse
    return out[:, None] if squeeze else out


def paged_attention(q, k_pages, v_pages, block_tables, valid_len, *,
                    scale: float = 1.0, force_kernel: bool = False):
    """Decode attention over a paged KV pool, as the JAX package's op.

    q: (B, 1, Hq, D) or (B, Hq, D); k_pages, v_pages in model layout
    (n_pool, page, Hkv, D), any strides with a contiguous last axis (a
    `PagedKVCache` pool's ``pool[:, :, 0]``); block_tables: (B, n_pages)
    page ids, padded with 0; valid_len: int or (B,) valid tokens per row."""
    _check_kernel_device(q, force_kernel)
    squeeze = q.ndim == 4
    if squeeze:
        q = q[:, 0]
    out = _paged.paged_attention(q, k_pages.transpose(1, 2),
                                 v_pages.transpose(1, 2), block_tables,
                                 valid_len, scale=scale)
    return out[:, None] if squeeze else out


def ssd_diag(x, dt, A, Bm, Cm, *, chunk: int = 256,
             force_kernel: bool = False):
    """Mamba-2 SSD diagonal block. x: (B, S, H, P); dt: (B, S, H); A: (H,);
    Bm, Cm: (B, S, N); float32. Returns (B, S, H, P) float32."""
    _check_kernel_device(x, force_kernel)
    if _needs_grad(x, dt, A, Bm, Cm):
        return _ssd.SSDDiagFn.apply(x, dt, A, Bm, Cm, chunk)
    return _ssd.ssd_diag(x, dt, A, Bm, Cm, chunk=chunk)


_KERNELS = {"flash_attention": _fa.flash_attention,
            "decode_attention": _dec.decode_attention,
            "paged_attention": _paged.paged_attention,
            "ssd_diag": _ssd.ssd_diag}


def kernel_launches() -> dict:
    """Launch counts of the kernels since the last `reset_launches`, and
    of the decode kernel's launches that wrote the logsumexp
    (``decode_attention_lse``, a share of ``decode_attention``'s)."""
    out = {name: fn.launches for name, fn in _KERNELS.items()}
    out["decode_attention_lse"] = _dec.decode_attention.lse_launches
    return out


def reset_launches() -> None:
    for fn in _KERNELS.values():
        fn.launches = 0
    _dec.decode_attention.lse_launches = 0


def add_launches(counts: dict) -> None:
    """Add `counts` (keys of `kernel_launches`; a missing key adds 0) to
    the launch counters. A CUDA graph's replay runs no wrapper, so the
    graph's owner adds the launches its capture recorded at each replay,
    and takes back those of the capture itself, which launched nothing."""
    for name, fn in _KERNELS.items():
        fn.launches += counts.get(name, 0)
    _dec.decode_attention.lse_launches += counts.get("decode_attention_lse", 0)

