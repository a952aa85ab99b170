"""Decode attention on the card: the wrapper of ``csrc/decode_attention.cu``,
a split-KV (flash-decoding) kernel and its combine pass.

On a CUDA tensor it launches the hand-written kernels, or raises; on a CPU
tensor it runs the plain version in ``ref.py``. ``decode_attention.launches``
counts the wrapper's calls that launched: one a call, however many kernels
the call runs (the split kernel, and the combine where there are splits).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (DTYPES, check_aligned,
                                                 check_last_contiguous,
                                                 check_operand)
from repro_torch.kernels.ref import (decode_attention_lse_ref,
                                     decode_attention_ref, split_plan)

HEAD_DIMS = (64, 128, 256)   # the dense entry's instantiations
# q-heads per kv-head: the M rows of the bf16 kernel's one mma tile (the
# float32 kernel splits a group above 8 across two CTAs)
MAX_GROUP = 16


def check_group(hq: int, hkv: int) -> None:
    """Raise unless ``hkv`` divides ``hq`` with at most MAX_GROUP q-heads
    per kv-head, the groups the decode kernels take (checked on every
    device, so that the CPU's plain version keeps the card's contract)."""
    if hkv <= 0 or hq % hkv or hq // hkv > MAX_GROUP:
        raise ValueError(f"q heads {hq} per kv heads {hkv}: the group must "
                         f"divide and be at most {MAX_GROUP}")


def valid_lengths(valid_len, b: int, device) -> torch.Tensor:
    """An int or (B,) integer `valid_len` as the (B,) contiguous int32
    tensor on `device` that the decode kernels read."""
    if isinstance(valid_len, torch.Tensor) and valid_len.dtype == torch.int32 \
            and valid_len.shape == (b,) and valid_len.device == device \
            and valid_len.is_contiguous():
        return valid_len      # the engine's per-row lengths, as they are
    vl = torch.as_tensor(valid_len, device=device)
    if vl.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"valid_len must be integer, got {vl.dtype}")
    vl = vl.to(torch.int32)
    vl = vl.expand(b) if vl.ndim == 0 else vl
    if vl.shape != (b,):
        raise ValueError(f"valid_len shape {tuple(vl.shape)}, expected ({b},)")
    return vl.contiguous()


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SM count of card ``index``, queried once."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_workspace(s: int, b: int, hq: int, hkv: int, d: int, device):
    """(n_split, split_len, workspace) of a split-KV decode over ``s`` slots:
    the split rule of `ref.split_plan` for this card, and the splits'
    float32 partial states ((m, l) pairs, then D accumulators each), None
    when there is one split."""
    n_split, split_len = split_plan(s, b * hkv, sm_count(device.index or 0))
    ws = (torch.empty(b * hq * n_split * (d + 2), dtype=torch.float32,
                      device=device) if n_split > 1 else None)
    return n_split, split_len, ws


def decode_attention(q, k, v, valid_len, *, scale: float = 1.0,
                     return_lse: bool = False):
    """q: (B, Hq, D); k, v: (B, Hkv, S, D); valid_len: int or (B,) int.

    Returns (B, Hq, D) in q.dtype, and with ``return_lse`` also each row's
    logsumexp of the masked ``scale * q.k``, (B, Hq) float32 (the kernel
    stores it after its merge: one store a row). Row b attends to cache
    slots ``[0, valid_len[b])``; a row with valid_len 0 gets the uniform
    mean of its V rows, and an lse of -1e30 + log(S). Any strides whose
    last axis is contiguous are taken as they are (the model passes (B, S,
    Hkv, D) caches as transposed views); on the card k and v are read as
    16-byte vectors, so their pointers and strides must be 16-byte aligned.
    ``decode_attention.lse_launches`` counts the launches with lse.
    """
    check_group(q.shape[1], k.shape[1])
    check_last_contiguous(q=q, k=k, v=v)
    if q.device.type in ("cpu", "meta"):
        plain = decode_attention_lse_ref if return_lse \
            else decode_attention_ref
        return plain(q, k, v, valid_len, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu, not {q.device}")
    b, hq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    hkv, s = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if b == 0 or s == 0:
        raise ValueError("empty attention")
    for name, x in (("q", q), ("k", k), ("v", v)):
        check_operand(name, x, q.dtype, q.device)
    check_aligned("k", k)
    check_aligned("v", v)
    vl = valid_lengths(valid_len, b, q.device)
    out = torch.empty_like(q)
    lse = torch.empty((b, hq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    n_split, split_len, ws = split_workspace(s, b, hq, hkv, d, q.device)
    strides = _build.int64_array(
        [q.stride(0), q.stride(1), *k.stride()[:3], *v.stride()[:3],
         out.stride(0), out.stride(1)])
    lib = _build.load_library()
    err = lib.repro_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), vl.data_ptr(),
        out.data_ptr(), None if ws is None else ws.data_ptr(),
        None if lse is None else lse.data_ptr(), strides, b,
        hq, hkv, s, d, n_split, split_len, float(scale), DTYPES[q.dtype],
        _build.raw_stream(q.device))
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    decode_attention.launches += 1
    if return_lse:
        decode_attention.lse_launches += 1
        return out, lse
    return out


decode_attention.launches = 0
decode_attention.lse_launches = 0
