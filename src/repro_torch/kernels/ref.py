"""Plain PyTorch versions of the CUDA kernels.

They compute what the CUDA kernels compute, in the simplest form: the
attention ones the whole logits tensor, a finite ``NEG_INF`` mask and a
float32 softmax; the SSD one every (query, key) pair of a chunk at once. The
CPU tests hold them against the JAX oracles, `chip_smoke.py` holds each
kernel against them on the card, and `repro_torch.kernels.ops` sends a
CPU tensor here. Layouts are the kernels' own: heads before sequence for
attention, the model's (B, S, H, P) for the SSD block.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30
# split-KV decode: the fewest slots a split holds (a cache this short, as
# the serving path's 256 slots, runs in one launch with no combine pass)
MIN_SPLIT_SLOTS = 256


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


def split_plan(s: int, rows: int, sms: int) -> tuple[int, int]:
    """(n_split, split_len) of a split-KV decode over ``s`` cache slots for
    ``rows`` (batch, kv-head) pairs on a card of ``sms`` SMs.

    It fills the card in one wave of CTAs, about one an SM (the bf16 kernel's
    K/V ring takes 135 KB of shared memory at D = 256), and gives no split
    fewer than ``MIN_SPLIT_SLOTS`` slots. It reads only shapes: the valid
    lengths lie on the card, and reading them would cost a device round trip
    a layer. The decode wrapper and `decode_attention_split_ref` both take it
    from here.
    """
    n = max(1, min(sms // max(rows, 1), s // MIN_SPLIT_SLOTS))
    split_len = -(-s // n)
    return -(-s // split_len), split_len


def decode_partials_ref(q, k, v, valid_len, *, scale: float, n_split: int,
                        split_len: int):
    """The per-split softmax states of split-KV decode, in float32.

    Split i covers slots ``[i * split_len, (i + 1) * split_len)`` of the
    ``n`` slots a row reads (``min(valid_len, S)``, or all S with the finite
    mask when valid_len is 0). Returns m, l of (B, Hq, n_split) and acc of
    (B, Hq, n_split, D); a split with no slot has m = -inf, l = 0, acc = 0.
    """
    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, d).float()
    logits = torch.einsum("bhgd,bhkd->bhgk", qg, k.float()) * scale
    vl = torch.as_tensor(valid_len, device=q.device).reshape(-1).expand(b)
    n = torch.where(vl > 0, torch.clamp(vl, max=s), torch.full_like(vl, s))
    present = torch.arange(s, device=q.device)[None, :] < n[:, None]
    logits = torch.where((vl > 0)[:, None, None, None], logits,
                         torch.full_like(logits, NEG_INF))
    logits = torch.where(present[:, None, None, :], logits,
                         torch.full_like(logits, -torch.inf))
    pad = n_split * split_len - s
    logits = F.pad(logits, (0, pad), value=-torch.inf).reshape(
        b, hkv, g, n_split, split_len)
    vs = F.pad(v.float(), (0, 0, 0, pad)).reshape(b, hkv, n_split, split_len, d)
    m = logits.amax(-1)
    empty = m == -torch.inf
    p = torch.where(empty[..., None], torch.zeros_like(logits),
                    torch.exp(logits - m[..., None]))
    acc = torch.einsum("bhgnk,bhnkd->bhgnd", p, vs)
    return (m.reshape(b, hq, n_split), p.sum(-1).reshape(b, hq, n_split),
            acc.reshape(b, hq, n_split, d))


def combine_partials_ref(m, l, acc):
    """Merge the splits' states (m, l: (..., n_split); acc: (..., n_split,
    D)) into the normalised rows (..., D), float32."""
    mx = m.amax(-1, keepdim=True)
    f = torch.where(m == -torch.inf, torch.zeros_like(m), torch.exp(m - mx))
    num = (f[..., None] * acc).sum(-2)
    return num / torch.clamp((f * l).sum(-1), min=1e-30)[..., None]


def decode_attention_split_ref(q, k, v, valid_len, *, scale: float = 1.0,
                               sms: int = 132):
    """`decode_attention_ref` computed as the split-KV kernel computes it:
    the wrapper's split rule for a card of ``sms`` SMs, per-split partial
    states, then the combine. Returns (B, Hq, D) in q.dtype."""
    n_split, split_len = split_plan(k.shape[2], q.shape[0] * k.shape[1], sms)
    m, l, acc = decode_partials_ref(q, k, v, valid_len, scale=scale,
                                    n_split=n_split, split_len=split_len)
    return combine_partials_ref(m, l, acc).to(q.dtype)


def paged_attention_ref(q, k_pages, v_pages, block_tables, valid_len, *,
                        scale: float = 1.0):
    """Decode attention through a page table: gather each row's pages into
    a dense cache, then run `decode_attention_ref`.

    q: (B, Hq, D); k_pages, v_pages: (n_pool, Hkv, page, D); block_tables:
    (B, n_pages) physical page ids (padded with page 0); valid_len: int,
    scalar or (B,) tensor. A row with valid_len 0 gets the uniform mean of V
    over every slot of its table, pad pages included.
    """
    b = q.shape[0]
    hkv, _, d = k_pages.shape[1:]
    idx = torch.as_tensor(block_tables, device=q.device).long()
    # (B, n_pages, Hkv, page, D) -> (B, Hkv, n_pages * page, D)
    k = k_pages[idx].transpose(1, 2).reshape(b, hkv, -1, d)
    v = v_pages[idx].transpose(1, 2).reshape(b, hkv, -1, d)
    return decode_attention_ref(q, k, v, valid_len, scale=scale)


def ssd_diag_ref(x, dt, A, Bm, Cm, *, chunk: int = 256):
    """The Mamba-2 SSD diagonal block, per chunk of the sequence:
    ``Y[i] = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j`` with
    ``cum = cumsum(dt * A)`` inside the chunk.

    x: (B, S, H, P); dt: (B, S, H) post-softplus; A: (H,) negative;
    Bm, Cm: (B, S, N). Returns (B, S, H, P) float32.
    """
    b, s, h, p = x.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"chunk {chunk} must divide the sequence {s}")
    nc = s // chunk
    xr = x.reshape(b, nc, chunk, h, p).float()
    dtr = dt.reshape(b, nc, chunk, h).float()
    Br = Bm.reshape(b, nc, chunk, -1).float()
    Cr = Cm.reshape(b, nc, chunk, -1).float()
    cum = torch.cumsum(dtr * A.float(), dim=2)
    dtx = dtr[..., None] * xr
    scores = torch.einsum("bcqn,bckn->bcqk", Cr, Br)
    decay = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    idx = torch.arange(chunk, device=x.device)
    mask = idx[:, None] >= idx[None, :]
    lmat = torch.where(mask[None, None, :, :, None], torch.exp(decay),
                       torch.zeros((), device=x.device))
    y = torch.einsum("bcqk,bcqkh,bckhp->bcqhp", scores, lmat, dtx)
    return y.reshape(b, s, h, p)
