"""The float32 flash kernel's decomposition on the CPU
(`ref.flash_attention_tiled_ref`: q-heads packed into rows, K/V tiles of
`flash_key_tile` keys walked by 16 rows at a time with the tiles outside
their horizon skipped, an online softmax in log2 units, both products in
3xTF32) against the JAX package's Pallas kernel in interpret mode and
against the plain versions. The CUDA kernel itself is held against both in
test_torch_gpu.py, on a card.

Inputs are made with numpy from a seed and handed to both packages. The
tolerance is the float32 one the JAX kernel tests pin, 2e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import ref as tref

TOL = 2e-5
REL_RMS = 0.05   # chip_smoke.py's phase-3 gate: max error / plain RMS


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The tiled reference runs thousands of small products: on one thread
    each, since the suite's other workers share the cores (a thread pool a
    product made this file 70 times slower there)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, b, hq, hkv, sq, sk, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, np.float32)
            for shape in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,window,q_offset", [
    (1, 2, 2, 64, 64, 48, True, 0, 0),        # G 1, MLA's reduced D 48
    (1, 4, 2, 128, 128, 64, True, 32, 0),     # G 2, window
    (1, 8, 1, 32, 64, 96, True, 0, 32),       # G 8, q_offset, D 96
    (1, 2, 1, 64, 128, 128, False, 0, 0),     # non-causal, Sq != Sk
    (1, 8, 1, 64, 64, 256, True, 16, 0),      # G 8, window, D 256
    (2, 2, 2, 64, 64, 256, False, 0, 0),      # non-causal D 256
    (1, 16, 2, 64, 64, 64, True, 0, 0),       # G 8, rows of two heads a warp
    (1, 4, 4, 64, 128, 96, True, 48, 64),     # window and q_offset
    (2, 8, 8, 1, 256, 64, False, 0, 0),       # one row: cross attention
])
def test_flash_tiled_ref_matches_pallas(b, hq, hkv, sq, sk, d, causal,
                                        window, q_offset):
    """The kernel's order of work against the Pallas kernel in interpret
    mode (64-row blocks, as tests/test_torch_kernels.py runs it) at 2e-5."""
    q, k, v = _inputs(1, b, hq, hkv, sq, sk, d)
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              scale=d ** -0.5)
    out, lse = tref.flash_attention_tiled_ref(
        *(torch.from_numpy(a) for a in (q, k, v)), **kw)
    pallas = pallas_flash(*(jnp.asarray(a) for a in (q, k, v)), block_q=64,
                          block_k=64, interpret=True, **kw)
    assert out.shape == (b, hq, sq, d) and out.dtype == torch.float32
    assert lse.shape == (b, hq, sq) and lse.dtype == torch.float32
    _close(out, pallas)


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,window,q_offset", [
    (1, 6, 2, 45, 77, 64, True, 0, 32),       # ragged tiles, q_offset
    (2, 3, 1, 70, 70, 96, True, 20, 0),       # ragged rows across heads
    (1, 4, 2, 33, 50, 48, True, 0, 17),
    (1, 10, 1, 19, 300, 128, False, 0, 0),    # ragged non-causal, G 10
    (1, 2, 1, 40, 100, 256, True, 64, 60),    # a prefix-hit suffix
    (2, 4, 4, 1, 700, 64, False, 0, 0),       # one row, cross decode
    (1, 2, 1, 16, 200, 128, True, 0, 184),    # a short suffix, long prefix
])
def test_flash_tiled_ref_ragged_matches_plain(b, hq, hkv, sq, sk, d, causal,
                                              window, q_offset):
    """Sq != Sk, tiles cut short at both ends, one query row against a long
    cache: the output and the logsumexp against `flash_attention_lse_ref`
    at 2e-5."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, b, hq, hkv, sq, sk, d))
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              scale=d ** -0.5)
    out, lse = tref.flash_attention_tiled_ref(q, k, v, **kw)
    plain, plain_lse = tref.flash_attention_lse_ref(q, k, v, **kw)
    _close(out, plain)
    _close(lse, plain_lse)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 24)])
@pytest.mark.parametrize("d", [48, 64, 96, 128, 256])
def test_flash_tiled_ref_lse_matches_plain(d, causal, window):
    """The logsumexp the kernel writes for the backward (m in log2 units
    times ln 2, plus log l) against the plain one at 2e-5, at every head
    dim."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(3, 1, 4, 2, 80, 80, d))
    kw = dict(causal=causal, window=window, scale=d ** -0.5)
    _, lse = tref.flash_attention_tiled_ref(q, k, v, **kw)
    _, plain_lse = tref.flash_attention_lse_ref(q, k, v, **kw)
    _close(lse, plain_lse)


def test_flash_tiled_ref_at_gemma3_12b_local_width():
    """gemma3-12b's local layer at the 1024 bucket (16 q-heads on 8, D 256,
    window 1024) against the plain version under chip_smoke.py's phase-3
    checks: allclose at 2e-5 and the largest error under 5% of the plain
    output's RMS."""
    q, k, v = (torch.from_numpy(a)
               for a in _inputs(4, 1, 16, 8, 1024, 1024, 256))
    kw = dict(causal=True, window=1024, scale=256 ** -0.5)
    out, _ = tref.flash_attention_tiled_ref(q, k, v, **kw)
    plain = tref.flash_attention_ref(q, k, v, **kw)
    rms = plain.pow(2).mean().sqrt().item()
    assert rms > 0
    _close(out, plain)
    assert (out - plain).abs().max().item() <= REL_RMS * rms


def _mm_tf32(a, b):
    """One TF32 product, as plain TF32 tensor cores take it."""
    return tref.tf32_round(a) @ tref.tf32_round(b)


def test_unrounded_lo_keeps_the_f32_accuracy():
    """The flash kernel hands lo over unrounded (the tensor core drops its
    low bits): each product stays within 2^-21 of the exact one, as with a
    rounded lo, where one TF32 product is off by up to 2^-10."""
    rng = np.random.default_rng(6)
    a = torch.from_numpy(rng.standard_normal((64, 256), np.float32))
    bm = torch.from_numpy(rng.standard_normal((256, 64), np.float32))
    exact = a.double() @ bm.double()
    scale = (a.double().abs() @ bm.double().abs()).max().item()
    err = {name: (mm(a, bm).double() - exact).abs().max().item() / scale
           for name, mm in (("flash", tref.mm_3xtf32_flash),
                            ("ssd", tref.mm_3xtf32), ("one", _mm_tf32))}
    assert err["flash"] <= 2.0 ** -21 and err["ssd"] <= 2.0 ** -21
    assert err["one"] > 2.0 ** -14


def test_single_tf32_misses_the_f32_tolerance_at_d256():
    """The same tiling with one TF32 product a multiply misses 2e-5 at
    D 256, where the three products of 3xTF32 meet it."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(5, 1, 4, 2, 128, 128, 256))
    kw = dict(causal=True, scale=256 ** -0.5)
    plain = tref.flash_attention_ref(q, k, v, **kw)
    one, _ = tref.flash_attention_tiled_ref(q, k, v, mm=_mm_tf32, **kw)
    three, _ = tref.flash_attention_tiled_ref(q, k, v, **kw)
    assert not torch.allclose(one, plain, rtol=TOL, atol=TOL)
    _close(three, plain)


def test_key_tile_and_skipped_tiles():
    """32-key tiles from D 96 up, 64 below; a causal row block past the
    first tiles skips them all, and a windowed one starts at the window's
    tile."""
    assert [tref.flash_key_tile(d) for d in (48, 64, 96, 128, 256)] == \
        [64, 64, 32, 32, 32]
    # rows 128..143 of one head, causal: keys [0, 144)
    assert tref._key_span(128, 143, 1000, True, 0, 0, 64) == (0, 144)
    # window 32: keys from 128 - 31 = 97, rounded down to the tile at 64
    assert tref._key_span(128, 143, 1000, True, 32, 0, 64) == (64, 144)
    # non-causal: every key; q_offset shifts the causal edge
    assert tref._key_span(0, 15, 300, False, 0, 0, 32) == (0, 300)
    assert tref._key_span(0, 15, 300, True, 0, 60, 32) == (0, 76)
