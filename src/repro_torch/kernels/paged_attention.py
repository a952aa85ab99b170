"""Paged decode attention on the card: the wrapper of
``csrc/paged_attention.cu``, the split-KV decode kernels reading K/V rows
through a page table, and their combine pass.

On a CUDA tensor it launches the hand-written kernels, or raises; on a CPU
tensor it runs the plain version in ``ref.py``. ``paged_attention.launches``
counts the wrapper's calls that launched: one a call, however many kernels
the call runs (the split kernel, and the combine where there are splits).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import (check_group,
                                                  split_workspace,
                                                  valid_lengths)
from repro_torch.kernels.flash_attention import (DTYPES, check_aligned,
                                                 check_operand)
from repro_torch.kernels.ref import paged_attention_ref

# the decode kernels' head_dims and the paged pool's 48, 80 and 96
HEAD_DIMS = (48, 64, 80, 96, 128, 256)


def paged_attention(q, k_pages, v_pages, block_tables, valid_len, *,
                    scale: float = 1.0, check_pages: bool = True):
    """q: (B, Hq, D); k_pages, v_pages: (n_pool, Hkv, page, D) (any strides
    whose last axis is contiguous; on the card the rows are read as 16-byte
    vectors, so pointers and strides must be 16-byte aligned); block_tables:
    (B, n_pages) integer page ids, padded with page 0; valid_len: int or
    (B,) integer.

    Returns (B, Hq, D) in q.dtype: row b attends to the first
    ``valid_len[b]`` slots of the pages its table names; a row with
    valid_len 0 gets the uniform mean of V over every slot of its table.
    ``check_pages`` checks that every page id lies in the pool, at the cost
    of one device round trip; a caller whose tables hold only ids from the
    pool's own allocator (a ``PagedKVCache``'s) may pass False.
    """
    check_group(q.shape[1], k_pages.shape[1])
    if q.device.type in ("cpu", "meta"):
        return paged_attention_ref(q, k_pages, v_pages, block_tables,
                                   valid_len, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu, not {q.device}")
    b, hq, d = q.shape
    n_pool, hkv, page, dk = k_pages.shape
    if dk != d or v_pages.shape != k_pages.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k_pages "
                         f"{tuple(k_pages.shape)}, v_pages "
                         f"{tuple(v_pages.shape)} do not match")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    for name, x in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        check_operand(name, x, q.dtype, q.device)
    check_aligned("k_pages", k_pages)
    check_aligned("v_pages", v_pages)
    tables = torch.as_tensor(block_tables, device=q.device)
    if tables.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"block_tables must be integer, got {tables.dtype}")
    if tables.ndim != 2 or tables.shape[0] != b or tables.shape[1] == 0 \
            or b == 0:
        raise ValueError(f"block_tables shape {tuple(tables.shape)}, "
                         f"expected ({b}, n_pages > 0)")
    if check_pages:
        # the kernel would read outside the pool
        lo, hi = torch.stack(torch.aminmax(tables)).tolist()
        if lo < 0 or hi >= n_pool:
            raise ValueError(f"block_tables name pages {lo}..{hi}, outside "
                             f"the pool's 0..{n_pool - 1}")
    tables = tables.to(torch.int32).contiguous()
    vl = valid_lengths(valid_len, b, q.device)
    out = torch.empty_like(q)
    n_pages = tables.shape[1]
    # the dense decode's split rule over the n_pages * page logical slots
    n_split, split_len, ws = split_workspace(n_pages * page, b, hq, hkv, d,
                                             q.device)
    strides = _build.int64_array(
        [q.stride(0), q.stride(1), *k_pages.stride()[:3],
         *v_pages.stride()[:3], out.stride(0), out.stride(1)])
    lib = _build.load_library()
    err = lib.repro_paged_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        tables.data_ptr(), vl.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), strides, b, hq, hkv, page,
        n_pages, d, n_split, split_len, float(scale), DTYPES[q.dtype],
        _build.raw_stream(q.device))
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
