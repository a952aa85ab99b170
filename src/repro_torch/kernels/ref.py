"""Plain PyTorch versions of the CUDA kernels.

They compute what the CUDA kernels compute, in the simplest form: the
attention ones the whole logits tensor, a finite ``NEG_INF`` mask and a
float32 softmax; the SSD one every (query, key) pair of a chunk at once. The
CPU tests hold them against the JAX oracles, `chip_smoke.py` holds each
kernel against them on the card, and `repro_torch.kernels.ops` sends a
CPU tensor here. Beside them, plain versions of the kernels' own
decompositions (split-KV decode, dense and paged; float32 flash and the
SSD block in tiles with 3xTF32 products), which the tests hold against
both. Layouts are the kernels' own: heads before sequence for attention,
the model's (B, S, H, P) for the SSD block.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30
# split-KV decode: the fewest slots a split holds (a cache this short, as
# the serving path's 256 slots, runs in one launch with no combine pass)
MIN_SPLIT_SLOTS = 256


def attention_mask(q_pos, k_pos, *, causal: bool, window: int):
    """Which keys each query sees: (len(q_pos), len(k_pos)) boolean, from
    absolute positions (``q_offset`` already added to the queries')."""
    qi, kj = q_pos[:, None], k_pos[None, :]
    mask = torch.ones((len(q_pos), len(k_pos)), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask = mask & (kj <= qi)
    if window > 0:
        mask = mask & (kj > qi - window)
    return mask


def _flash_logits(q, k, causal, window, q_offset, scale):
    """The masked float32 logits (B, Hkv, G, Sq, Sk) of q against k."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, sq, d).float()
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    mask = attention_mask(torch.arange(sq, device=q.device) + q_offset,
                          torch.arange(sk, device=q.device), causal=causal,
                          window=window)
    return torch.where(mask, logits, torch.full_like(logits, NEG_INF))


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        q_offset: int = 0, scale: float = 1.0):
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D). GQA via head grouping.

    Returns (B, Hq, Sq, D) in q.dtype; softmax in f32.
    """
    b, hq, sq, d = q.shape
    logits = _flash_logits(q, k, causal, window, q_offset, scale)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, v.float())
    return out.reshape(b, hq, sq, d).to(q.dtype)


def flash_attention_lse_ref(q, k, v, *, causal: bool = True, window: int = 0,
                            q_offset: int = 0, scale: float = 1.0):
    """`flash_attention_ref` with each row's logsumexp of the masked
    ``scale * q.k``, the statistic the kernel writes for the backward.

    Returns (out (B, Hq, Sq, D) in q.dtype, lse (B, Hq, Sq) float32)."""
    b, hq, sq, d = q.shape
    logits = _flash_logits(q, k, causal, window, q_offset, scale)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, v.float())
    lse = torch.logsumexp(logits, dim=-1)
    return out.reshape(b, hq, sq, d).to(q.dtype), lse.reshape(b, hq, sq)


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


def decode_attention_lse_ref(q, k, v, valid_len, *, scale: float = 1.0):
    """`decode_attention_ref` with each row's logsumexp of the masked
    ``scale * q.k`` (the finite NEG_INF mask: a row with valid_len 0 gets
    ``NEG_INF + log(S)``, which weighs zero in `cp_combine_ref`).

    Returns (out (B, Hq, D) in q.dtype, lse (B, Hq) float32)."""
    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, d).float()
    logits = torch.einsum("bhgd,bhkd->bhgk", qg, k.float()) * scale
    vl = torch.as_tensor(valid_len, device=q.device).reshape(-1, 1)
    valid = torch.arange(s, device=q.device)[None, :] < vl
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgk,bhkd->bhgd", probs, v.float())
    return (out.reshape(b, hq, d).to(q.dtype),
            torch.logsumexp(logits, dim=-1).reshape(b, hq))


def cp_combine_ref(outs, lses):
    """The context-parallel decode's combine of the shards' rows (each
    (B, H, D)) by their logsumexps (each (B, H)):
    ``sum_r exp(lse_r - max) out_r / sum_r exp(lse_r - max)``, float32."""
    lse = torch.stack(lses)                           # (R, B, H)
    w = torch.exp(lse - lse.amax(0, keepdim=True))
    out = torch.stack([o.float() for o in outs])      # (R, B, H, D)
    return (w[..., None] * out).sum(0) / w.sum(0)[..., None]


def cp_decode_ref(q, ks, vs, valid_lens, *, scale: float = 1.0):
    """The context-parallel decode body in the JAX package's einsum form:
    each shard's (m, l, acc) over its slice of the cache (ks[r], vs[r]:
    (B, Hkv, S_r, D); valid_lens[r]: its valid slots, (B,)), combined by
    max and sum. q: (B, Hq, D). Returns (B, Hq, D) float32."""
    b, hq, d = q.shape
    hkv = ks[0].shape[1]
    qg = q.reshape(b, hkv, hq // hkv, d).float()
    ms, ls, accs = [], [], []
    for k, v, vl in zip(ks, vs, valid_lens, strict=True):
        s = torch.einsum("bhgd,bhkd->bhgk", qg, k.float()) * scale
        valid = torch.arange(k.shape[2], device=q.device)[None, :] \
            < torch.as_tensor(vl, device=q.device).reshape(-1, 1)
        s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
        m = s.amax(-1)
        p = torch.exp(s - m[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bhgk,bhkd->bhgd", p, v.float()))
    m_g = torch.stack(ms).amax(0)
    corr = [torch.exp(m - m_g) for m in ms]
    l_g = sum(lv * c for lv, c in zip(ls, corr, strict=True))
    acc = sum(a * c[..., None] for a, c in zip(accs, corr, strict=True))
    return (acc / torch.clamp(l_g, min=1e-30)[..., None]).reshape(b, hq, d)


def split_plan(s: int, rows: int, sms: int) -> tuple[int, int]:
    """(n_split, split_len) of a split-KV decode over ``s`` cache slots for
    ``rows`` (batch, kv-head) pairs on a card of ``sms`` SMs.

    It fills the card in one wave of CTAs, about one an SM (the bf16 kernel's
    K/V ring takes 135 KB of shared memory at D = 256), and gives no split
    fewer than ``MIN_SPLIT_SLOTS`` slots. It reads only shapes: the valid
    lengths lie on the card, and reading them would cost a device round trip
    a layer. The decode and paged wrappers and their split-KV plain versions
    all take it from here.
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


def gather_pages(pages, block_tables):
    """Each row's pages laid out densely: (n_pool, Hkv, page, D) through a
    (B, n_pages) table -> (B, Hkv, n_pages * page, D)."""
    idx = torch.as_tensor(block_tables, device=pages.device).long()
    b = idx.shape[0]
    hkv, _, d = pages.shape[1:]
    # (B, n_pages, Hkv, page, D) -> (B, Hkv, n_pages * page, D)
    return pages[idx].transpose(1, 2).reshape(b, hkv, -1, d)


def paged_attention_ref(q, k_pages, v_pages, block_tables, valid_len, *,
                        scale: float = 1.0):
    """Decode attention through a page table: gather each row's pages into
    a dense cache, then run `decode_attention_ref`.

    q: (B, Hq, D); k_pages, v_pages: (n_pool, Hkv, page, D); block_tables:
    (B, n_pages) physical page ids (padded with page 0); valid_len: int,
    scalar or (B,) tensor. A row with valid_len 0 gets the uniform mean of V
    over every slot of its table, pad pages included.
    """
    return decode_attention_ref(q, gather_pages(k_pages, block_tables),
                                gather_pages(v_pages, block_tables),
                                valid_len, scale=scale)


def paged_attention_split_ref(q, k_pages, v_pages, block_tables, valid_len,
                              *, scale: float = 1.0, sms: int = 132):
    """`paged_attention_ref` computed as the paged kernel computes it: the
    dense decode's split rule over the table's ``n_pages * page`` logical
    slots for a card of ``sms`` SMs, per-split partial states, then the
    combine. Returns (B, Hq, D) in q.dtype."""
    k = gather_pages(k_pages, block_tables)
    v = gather_pages(v_pages, block_tables)
    n_split, split_len = split_plan(k.shape[2], q.shape[0] * k.shape[1], sms)
    m, l, acc = decode_partials_ref(q, k, v, valid_len, scale=scale,
                                    n_split=n_split, split_len=split_len)
    return combine_partials_ref(m, l, acc).to(q.dtype)


def ssd_diag_ref(x, dt, A, Bm, Cm, *, chunk: int = 256,
                 dtype=torch.float32):
    """The Mamba-2 SSD diagonal block, per chunk of the sequence:
    ``Y[i] = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j`` with
    ``cum = cumsum(dt * A)`` inside the chunk.

    x: (B, S, H, P); dt: (B, S, H) post-softplus; A: (H,) negative;
    Bm, Cm: (B, S, N). The sums are taken in `dtype` (float64 gives a
    reference for the float32 versions' own rounding). Returns (B, S, H, P)
    float32.
    """
    b, s, h, p = x.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"chunk {chunk} must divide the sequence {s}")
    nc = s // chunk
    xr = x.reshape(b, nc, chunk, h, p).to(dtype)
    dtr = dt.reshape(b, nc, chunk, h).to(dtype)
    Br = Bm.reshape(b, nc, chunk, -1).to(dtype)
    Cr = Cm.reshape(b, nc, chunk, -1).to(dtype)
    cum = torch.cumsum(dtr * A.to(dtype), dim=2)
    dtx = dtr[..., None] * xr
    scores = torch.einsum("bcqn,bckn->bcqk", Cr, Br)
    decay = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    idx = torch.arange(chunk, device=x.device)
    mask = idx[:, None] >= idx[None, :]
    # masked before the exp: above the diagonal decay > 0 may overflow, and
    # exp's gradient there would be inf * 0 = nan
    lmat = torch.exp(torch.where(mask[None, None, :, :, None], decay,
                                 torch.full((), -torch.inf, dtype=dtype,
                                            device=x.device)))
    y = torch.einsum("bcqk,bcqkh,bckhp->bcqhp", scores, lmat, dtx)
    return y.reshape(b, s, h, p).float()


# the SSD kernel's q- and k-tiles: rows of a tile of C·Bᵀ
SSD_TILE = 64


def tf32_round(x):
    """float32 -> the nearest TF32 value (10 mantissa bits, ties away from
    zero), as the SSD kernel rounds an operand for the tensor cores: add half
    of the dropped part to the bits, then clear the low 13."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_truncate(x):
    """float32 -> TF32 by dropping the low 13 bits, as the tensor core reads
    a float32 register handed to it as TF32."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def mm_3xtf32(a, b, *, round_lo: bool = True):
    """``a @ b`` as the SSD kernel's tensor cores take it: each float32
    operand split into TF32 hi + lo, and lo·hi + hi·lo + hi·hi summed in
    float32 (lo·lo, some 2^-22 of a product, is left out). With
    ``round_lo=False`` lo is truncated, as the float32 flash kernel hands it
    over unrounded."""
    lo = tf32_round if round_lo else tf32_truncate
    ah = tf32_round(a)
    al = lo(a - ah)
    bh = tf32_round(b)
    bl = lo(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def mm_3xtf32_flash(a, b):
    """`mm_3xtf32` as the float32 flash kernel takes it: lo unrounded."""
    return mm_3xtf32(a, b, round_lo=False)


# the float32 flash kernel's packed query rows a warp
FLASH_WARP_ROWS = 16
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


def flash_key_tile(d: int) -> int:
    """Keys a K/V tile of the float32 flash kernel at head_dim ``d``."""
    return 32 if d >= 96 else 64


def _key_span(q_lo, q_hi, sk, causal, window, q_offset, bk):
    """The keys [begin, end) some query in [q_lo, q_hi] may see, begin
    rounded down to a tile of ``bk`` (``flash_tiles.cuh::key_span``)."""
    end = min(q_hi + q_offset + 1, sk) if causal else sk
    begin = q_lo + q_offset - window + 1 if window > 0 else 0
    begin = (begin // bk) * bk if begin > 0 else 0
    return begin, max(end, begin)


def _packed_span(r0, r1, sq):
    """The least and greatest query among packed rows [r0, r1): every
    query where the rows cross into the next head."""
    if r0 // sq != (r1 - 1) // sq:
        return 0, sq - 1
    return r0 % sq, (r1 - 1) % sq


def _flash_state(qw, qpos, kf, vf, sk, tiles, bk, *, causal, window,
                 scale_log2, mm):
    """One warp's online softmax over its K/V tiles (keys [k0, k0 + bk) of
    kf, vf for each k0 in ``tiles``, zero-padded past the sk keys): m in
    log2 units, l and acc, float32."""
    b, hkv, n, d = qw.shape
    m_run = torch.full((b, hkv, n), -torch.inf)
    l_run = torch.zeros(b, hkv, n)
    acc = torch.zeros(b, hkv, n, d)
    for k0 in tiles:
        kpos = torch.arange(k0, k0 + bk)
        present = kpos < sk
        kt = kf[:, :, k0:k0 + bk]
        vt = vf[:, :, k0:k0 + bk]
        s = mm(qw, kt.transpose(-1, -2))
        seen = attention_mask(qpos, kpos, causal=causal, window=window)
        s = torch.where(seen, s, torch.full_like(s, NEG_INF))
        s = torch.where(present, s, torch.full_like(s, -torch.inf))
        xm = torch.where(seen & present, s * scale_log2, s)
        m_new = torch.maximum(m_run, xm.amax(-1))
        alpha = torch.exp2(m_run - m_new)
        # p = 2^(s * scale_log2 - m), one rounding as the kernel's fused
        # multiply-add; the masked keys' finite NEG_INF as it stands
        p = torch.where(
            s == NEG_INF, torch.exp2(NEG_INF - m_new[..., None]),
            torch.exp2((s.double() * scale_log2.double()
                        - m_new[..., None].double()).float()))
        l_run = l_run * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + mm(p, vt)
        m_run = m_new
    return m_run, l_run, acc


def flash_attention_tiled_ref(q, k, v, *, causal: bool = True, window: int = 0,
                              q_offset: int = 0, scale: float = 1.0,
                              mm=mm_3xtf32_flash):
    """`flash_attention_lse_ref` computed as the float32 flash kernel
    computes it.

    The g q-heads of a kv-head are packed into rows (row r is q-head r // Sq,
    query r % Sq), 64 to a CTA, which loads the K/V tiles of
    `flash_key_tile` keys that some of its queries may see; each 16 rows (a
    warp) walk the tiles that some of their own queries may see and skip
    the rest. Keys a row may not see are masked with the finite NEG_INF
    (keys past Sk get no weight at all), the online softmax is kept in log2
    units (the scale folded into ``scale * log2 e``), and S = Q·Kᵀ and
    O += P·V go through ``mm`` (`mm_3xtf32_flash`, the kernel's three TF32
    products). Shapes as `flash_attention_ref`; returns (out in q.dtype,
    lse (B, Hq, Sq) float32).
    """
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    rows = hq // hkv * sq
    bk = flash_key_tile(d)
    scale_log2 = torch.tensor(scale * LOG2E, dtype=torch.float32)
    qp = q.float().reshape(b, hkv, rows, d)
    pad = (0, 0, 0, -sk % bk)   # zero keys past sk, as the kernel loads them
    kf, vf = F.pad(k.float(), pad), F.pad(v.float(), pad)
    out = torch.zeros(b, hkv, rows, d)
    lse = torch.zeros(b, hkv, rows)
    for w0 in range(0, rows, FLASH_WARP_ROWS):
        pr = torch.arange(w0, min(w0 + FLASH_WARP_ROWS, rows))
        begin, end = _key_span(*_packed_span(w0, int(pr[-1]) + 1, sq), sk,
                               causal, window, q_offset, bk)
        m_run, l_run, acc = _flash_state(
            qp[:, :, pr], pr % sq + q_offset, kf, vf, sk,
            range(begin, end, bk), bk, causal=causal, window=window,
            scale_log2=scale_log2, mm=mm)
        denom = torch.clamp(l_run, min=1e-30)
        out[:, :, pr] = acc / denom[..., None]
        m = torch.where(m_run == NEG_INF, m_run, m_run * LN2)
        lse[:, :, pr] = m + torch.log(denom)
    return (out.reshape(b, hq, sq, d).to(q.dtype),
            lse.reshape(b, hq, sq))


def ssd_diag_tiled_ref(x, dt, A, Bm, Cm, *, chunk: int = 256):
    """`ssd_diag_ref` decomposed as the CUDA kernel computes it.

    Per chunk: C·Bᵀ once for all heads, in ``SSD_TILE``-row tiles and only
    for the causal tile pairs (k-tile <= q-tile); cum = the sequential
    float32 sum of round(dt * A) per head, in the reference's order; then per
    (q-tile, head) W = S ⊙ exp(cum_i - cum_j) over the k-tiles up to the
    diagonal and Y += W·(dt x). Both products in 3xTF32 (`mm_3xtf32`).
    Shapes as `ssd_diag_ref`; returns (B, S, H, P) float32.
    """
    b, s, h, p = x.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"chunk {chunk} must divide the sequence {s}")
    nc, t = s // chunk, SSD_TILE
    xr = x.reshape(b, nc, chunk, h, p).float()
    dtr = dt.reshape(b, nc, chunk, h).float()
    Br = Bm.reshape(b, nc, chunk, -1).float()
    Cr = Cm.reshape(b, nc, chunk, -1).float()
    inc = dtr * A.float()
    y = torch.zeros_like(xr)
    for c in range(nc):
        run = torch.zeros_like(inc[:, c, 0])
        sums = []
        for j in range(chunk):
            run = run + inc[:, c, j]
            sums.append(run)
        cum = torch.stack(sums, dim=1)                          # (B, Q, H)
        dtx = (dtr[:, c, :, :, None] * xr[:, c]).permute(0, 2, 1, 3)
        for i0 in range(0, chunk, t):
            ii = torch.arange(i0, min(chunk, i0 + t), device=x.device)
            acc = torch.zeros(b, h, len(ii), p, device=x.device)
            for j0 in range(0, i0 + 1, t):
                jj = torch.arange(j0, min(chunk, j0 + t), device=x.device)
                scores = mm_3xtf32(Cr[:, c, ii], Br[:, c, jj].transpose(1, 2))
                decay = cum[:, ii, None, :] - cum[:, None, jj, :]   # (B,I,J,H)
                live = (jj[None, :] <= ii[:, None])[None, :, :, None]
                w = torch.where(live, scores[..., None] * torch.exp(decay),
                                torch.zeros((), device=x.device))
                acc = acc + mm_3xtf32(w.permute(0, 3, 1, 2), dtx[:, :, jj])
            y[:, c, ii] = acc.permute(0, 2, 1, 3)
    return y.reshape(b, s, h, p)
