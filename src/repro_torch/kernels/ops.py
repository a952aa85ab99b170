"""Model-layout entry points of the attention kernels.

They take the model's (B, S, H, D) tensors and hand the kernels
(B, H, S, D) views of them, with no copy. The device picks the path: a CPU
tensor runs the plain version, a CUDA tensor the hand-written kernel, which
launches or raises. ``force_kernel=True`` on a CPU tensor raises, as the
JAX package's ``_auto_interpret`` does when the Pallas lowering is forced
where it cannot run.
"""
from __future__ import annotations

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa


def _check_kernel_device(x, force_kernel: bool) -> None:
    if force_kernel and x.device.type != "cuda":
        raise RuntimeError(
            f"the CUDA kernel was forced on a {x.device.type} tensor; the "
            f"kernels run only on the card (leave force_kernel=False to take "
            f"the plain version on the CPU)")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, scale: float = 1.0,
                    force_kernel: bool = False):
    """q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D) -> (B, Sq, Hq, D)."""
    _check_kernel_device(q, force_kernel)
    out = _fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal, window=window,
                              q_offset=q_offset, scale=scale)
    return out.transpose(1, 2)


def decode_attention(q, k, v, valid_len, *, scale: float = 1.0,
                     force_kernel: bool = False):
    """q: (B, 1, Hq, D) or (B, Hq, D); k, v: (B, S, Hkv, D);
    valid_len: int or (B,) valid cache slots per row."""
    _check_kernel_device(q, force_kernel)
    squeeze = q.ndim == 4
    if squeeze:
        q = q[:, 0]
    out = _dec.decode_attention(q, k.transpose(1, 2), v.transpose(1, 2),
                                valid_len, scale=scale)
    return out[:, None] if squeeze else out


def kernel_launches() -> dict:
    """Launch counts of the kernels since the last `reset_launches`."""
    return {"flash_attention": _fa.flash_attention.launches,
            "decode_attention": _dec.decode_attention.launches}


def reset_launches() -> None:
    _fa.flash_attention.launches = 0
    _dec.decode_attention.launches = 0

