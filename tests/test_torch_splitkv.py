"""Split-KV (flash-decoding) decode: the split rule that the card's decode
and paged wrappers use, and the plain split-KV versions built on it
(per-split partial states, then the combine), dense and through a page
table, held against the plain versions and the JAX package's Pallas decode
and paged kernels in interpret mode. The CUDA kernels themselves are held
against these in test_torch_gpu.py, on a card.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: float32 2e-5, bfloat16 2e-2, as the JAX kernel tests pin.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.paged_attention import paged_attention as pallas_paged
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import check_aligned
from repro_torch.kernels.paged_attention import paged_attention

DTYPES = [("float32", 2e-5), ("bfloat16", 2e-2)]
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, np.float32)


@pytest.mark.parametrize("s,rows,sms,want", [
    (4096, 32, 132, (4, 1024)),    # gemma-2b at B = 32: one wave, 128 CTAs
    (4096, 4, 132, (16, 256)),     # B = 4: capped at 256-slot splits
    (256, 4, 132, (1, 256)),       # the serving path's cache: one launch
    (64, 2, 132, (1, 64)),         # too short to split
    (4096, 400, 132, (1, 4096)),   # the card is full without splits
    (1000, 8, 16, (2, 500)),       # a smaller card
    (2048, 2, 132, (8, 256)),
])
def test_split_plan_rule(s, rows, sms, want):
    assert ref.split_plan(s, rows, sms) == want


@pytest.mark.parametrize("sms", [8, 132])
def test_split_plan_covers_every_slot(sms):
    for s in (1, 7, 63, 64, 65, 127, 256, 1000, 4096, 32768):
        for rows in (1, 3, 4, 32, 128, 1000):
            n, length = ref.split_plan(s, rows, sms)
            assert n >= 1 and (n - 1) * length < s <= n * length
            assert n == 1 or length >= ref.MIN_SPLIT_SLOTS
            assert n == 1 or n * rows <= sms       # one wave of CTAs


def _edges(length, s, b):
    """valid_len 0, 1, a split boundary, one past it, S, rows whose later
    splits are empty, cycled over b rows."""
    edges = [0, 1, length, length + 1, s, length - 1, min(2 * length, s),
             s - 1]
    return np.asarray([edges[i % len(edges)] for i in range(b)], np.int32)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("b", [1, 4, 32])
def test_split_plain_matches_decode_and_pallas(dtype, tol, b):
    _check_dense_split(dtype, tol, b, 4, 2)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("hq,hkv", [(10, 1), (20, 2), (16, 1)])
def test_split_plain_at_large_groups_matches_pallas(dtype, tol, hq, hkv):
    """10 and 16 q-heads per kv-head (recurrentgemma-2b has 10 on 1), which
    the decode kernels take since the group limit is 16."""
    _check_dense_split(dtype, tol, 4, hq, hkv)


def _check_dense_split(dtype, tol, b, hq, hkv):
    s, d = 512, 64
    n_split, length = ref.split_plan(s, b * hkv, 132)
    assert n_split > 1
    valid = _edges(length, s, b)
    qn, kn, vn = (_normal(70, b, hq, d), _normal(71, b, hkv, s, d),
                  _normal(72, b, hkv, s, d))
    qt, kt, vt = (torch.from_numpy(x).to(TORCH_DT[dtype])
                  for x in (qn, kn, vn))
    out = ref.decode_attention_split_ref(qt, kt, vt, torch.from_numpy(valid),
                                         scale=0.125, sms=132)
    assert out.dtype == qt.dtype
    plain = ref.decode_attention_ref(qt, kt, vt, torch.from_numpy(valid),
                                     scale=0.125)
    np.testing.assert_allclose(out.float().numpy(), plain.float().numpy(),
                               rtol=tol, atol=tol)
    qj, kj, vj = (jnp.asarray(x).astype(JAX_DT[dtype]) for x in (qn, kn, vn))
    oracle = jref.decode_attention_ref(qj, kj, vj, jnp.asarray(valid),
                                       scale=0.125)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(oracle, np.float32), rtol=tol,
                               atol=tol)
    # the Pallas kernel takes one valid_len: one call per distinct value
    for n in sorted(set(valid.tolist())):
        rows = np.flatnonzero(valid == n)
        got = pallas_decode(qj[rows], kj[rows], vj[rows], int(n), scale=0.125,
                            block_k=128, interpret=True)
        np.testing.assert_allclose(out.float().numpy()[rows],
                                   np.asarray(got, np.float32), rtol=tol,
                                   atol=tol)


def test_split_partials_of_empty_splits():
    """A split past a row's valid slots holds m = -inf, l = 0, acc = 0; a
    row with valid_len 0 covers every split with the finite mask, so every
    split holds l = its slot count and the combine is the uniform mean."""
    b, hq, hkv, s, d = 2, 2, 1, 256, 16
    q = torch.from_numpy(_normal(73, b, hq, d))
    k = torch.from_numpy(_normal(74, b, hkv, s, d))
    v = torch.from_numpy(_normal(75, b, hkv, s, d))
    m, l, acc = ref.decode_partials_ref(q, k, v, torch.tensor([70, 0]),
                                        scale=0.25, n_split=4, split_len=64)
    assert torch.isfinite(m[0, :, :2]).all()
    assert (m[0, :, 2:] == -torch.inf).all() and (l[0, :, 2:] == 0).all()
    assert (acc[0, :, 2:] == 0).all()
    assert (m[1] == ref.NEG_INF).all()
    torch.testing.assert_close(l[1], torch.full((hq, 4), 64.0))
    out = ref.combine_partials_ref(m, l, acc)
    torch.testing.assert_close(out[1], v[1].mean(1).expand(hq, d))
    torch.testing.assert_close(
        out, ref.decode_attention_ref(q, k, v, torch.tensor([70, 0]),
                                      scale=0.25), rtol=2e-5, atol=2e-5)


def test_check_aligned_takes_model_views_and_refuses_odd_ones():
    x = torch.zeros(2, 64, 4, 64, dtype=torch.bfloat16)
    check_aligned("k", x.transpose(1, 2))            # a model-layout view
    check_aligned("k", x[:, :, :1].transpose(1, 2))  # one head: its stride
    with pytest.raises(ValueError, match="16-byte aligned"):
        check_aligned("k", x[..., 1:33])             # pointer off by 2 bytes
    with pytest.raises(ValueError, match="16-byte aligned"):
        check_aligned("k", torch.zeros(2, 3, 68,
                                       dtype=torch.bfloat16)[..., :64])


# ---------------------------------------------------------------------------
# paged decode on the split-KV kernel: the dense decode's splits over the
# table's n_pages * page logical slots
# ---------------------------------------------------------------------------

PAGED_SPAN = 1024      # logical slots a table names: at least two splits


def _paged_case(seed, b, hq, hkv, d, page, dtype):
    """Pools (n_pool, Hkv, page, D) and shuffled tables whose pad entry
    (the last of row 0) is page 0, which the last row also reads as its
    first page: the pad aliases a live page."""
    n_pages = PAGED_SPAN // page
    n_pool = b * n_pages + 3
    qn = _normal(seed, b, hq, d)
    kn = _normal(seed + 1, n_pool, hkv, page, d)
    vn = _normal(seed + 2, n_pool, hkv, page, d)
    perm = np.random.default_rng(seed + 3).permutation(n_pool)[: b * n_pages]
    tab = perm.reshape(b, n_pages).astype(np.int32)
    tab[-1, 0] = 0
    tab[0, -1] = 0
    return qn, kn, vn, tab


def _paged_edges(split_len, page, b):
    """valid_len 0 and 1, split and page boundaries and one past them,
    every slot, and rows whose later splits are empty."""
    edges = [0, 1, split_len, split_len + 1, page, page + 1, PAGED_SPAN,
             split_len - 1, PAGED_SPAN - 1, 2 * page]
    if b == 1:
        return [np.asarray([e], np.int32) for e in edges]
    return [np.asarray([edges[(i + k) % len(edges)] for i in range(b)],
                       np.int32) for k in range(0, len(edges), b)]


def _check_paged_split(dtype, tol, b, hq, hkv, d, page, seed):
    qn, kn, vn, tab = _paged_case(seed, b, hq, hkv, d, page, dtype)
    n_split, split_len = ref.split_plan(PAGED_SPAN, b * hkv, 132)
    assert n_split > 1
    qt, kt, vt = (torch.from_numpy(x).to(TORCH_DT[dtype])
                  for x in (qn, kn, vn))
    qj, kj, vj = (jnp.asarray(x).astype(JAX_DT[dtype]) for x in (qn, kn, vn))
    for valid in _paged_edges(split_len, page, b):
        out = ref.paged_attention_split_ref(qt, kt, vt, torch.from_numpy(tab),
                                            torch.from_numpy(valid),
                                            scale=d ** -0.5, sms=132)
        assert out.dtype == qt.dtype and out.shape == (b, hq, d)
        plain = ref.paged_attention_ref(qt, kt, vt, torch.from_numpy(tab),
                                        torch.from_numpy(valid),
                                        scale=d ** -0.5)
        np.testing.assert_allclose(out.float().numpy(),
                                   plain.float().numpy(), rtol=tol, atol=tol)
        got = pallas_paged(qj, kj, vj, jnp.asarray(tab), jnp.asarray(valid),
                           scale=d ** -0.5, interpret=True)
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(got, np.float32), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("page", [16, 32, 64])
@pytest.mark.parametrize("b", [1, 4, 32])
def test_paged_split_plain_matches_pallas(dtype, tol, b, page):
    """The plain split-KV paged version (what the paged kernel computes:
    the split rule over the table's logical slots, partial states, the
    combine) against the JAX Pallas paged kernel in interpret mode, with
    valid lengths on split and page boundaries, 0 and 1, and shuffled
    tables whose pad entry aliases a live page."""
    _check_paged_split(dtype, tol, b, 4, 2, 64, page, seed=80)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("d", [48, 80])
def test_paged_split_plain_odd_head_dims(dtype, tol, d):
    """head_dims 48 and 80, which only the paged wrapper takes."""
    _check_paged_split(dtype, tol, 4, 4, 2, d, 16, seed=90)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("hq", [10, 16])
def test_paged_split_plain_at_large_groups(dtype, tol, hq):
    """10 and 16 q-heads on one kv-head through a page table."""
    _check_paged_split(dtype, tol, 4, hq, 1, 64, 16, seed=95)


@pytest.mark.parametrize("hq,hkv", [(17, 1), (34, 2), (12, 8), (6, 4)])
def test_wrappers_refuse_groups_they_cannot_take(hq, hkv):
    """Both decode wrappers take every group that divides up to 16 and
    raise above 16 or when the kv-heads do not divide the q-heads, on the
    CPU as on the card."""
    q = torch.zeros(2, hq, 64)
    cache = torch.zeros(2, hkv, 32, 64)
    pool = torch.zeros(4, hkv, 16, 64)
    tables = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    with pytest.raises(ValueError, match="at most 16"):
        decode_attention(q, cache, cache, 5)
    with pytest.raises(ValueError, match="at most 16"):
        paged_attention(q, pool, pool, tables, 5)


@pytest.mark.parametrize("g", range(1, 17))
def test_wrappers_take_every_group_up_to_16(g):
    q = torch.from_numpy(_normal(96, 2, g, 64))
    cache = torch.from_numpy(_normal(97, 2, 1, 32, 64))
    out = decode_attention(q, cache, cache, 5)
    assert out.shape == (2, g, 64)
    torch.testing.assert_close(
        out, ref.decode_attention_ref(q, cache, cache, 5))
    pool = cache.reshape(4, 1, 16, 64)
    tables = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    torch.testing.assert_close(paged_attention(q, pool, pool, tables, 5),
                               out)
