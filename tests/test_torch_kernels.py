"""The port's attention kernels: the plain versions against the JAX oracles
and the Pallas kernels (interpret mode). The CUDA kernels themselves are
held against the plain versions in test_torch_gpu.py, on a card.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances are the ones the JAX kernel tests pin: float32 2e-5, bfloat16
2e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention

DTYPES = [("float32", 2e-5), ("bfloat16", 2e-2)]
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, np.float32)


def _both(a, dtype):
    """The same values in both packages (bf16 rounds identically)."""
    return (jnp.asarray(a).astype(JAX_DT[dtype]),
            torch.from_numpy(a).to(TORCH_DT[dtype]))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# plain versions vs the JAX oracles and the Pallas kernels (CPU)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("shape", [
    (1, 128, 128, 2, 2, 64),     # MHA
    (2, 128, 128, 4, 2, 64),     # GQA
    (1, 128, 128, 4, 1, 128),    # MQA, head_dim 128
])
@pytest.mark.parametrize("window", [0, 64])
def test_flash_plain_matches_jax_and_pallas(dtype, tol, shape, window):
    b, sq, sk, hq, hkv, d = shape
    qj, qt = _both(_normal(1, b, hq, sq, d), dtype)
    kj, kt = _both(_normal(2, b, hkv, sk, d), dtype)
    vj, vt = _both(_normal(3, b, hkv, sk, d), dtype)
    scale = 1.0 / np.sqrt(d)
    out = flash_attention(qt, kt, vt, causal=True, window=window, scale=scale)
    ref = jref.flash_attention_ref(qj, kj, vj, causal=True, window=window,
                                   scale=scale)
    pallas = pallas_flash(qj, kj, vj, causal=True, window=window, scale=scale,
                          block_q=64, block_k=64, interpret=True)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(out), _np(pallas), rtol=tol, atol=tol)


@pytest.mark.parametrize("causal,window,q_offset", [
    (True, 0, 32), (True, 16, 40), (False, 0, 0)])
def test_flash_plain_offset_and_noncausal(causal, window, q_offset):
    qj, qt = _both(_normal(4, 1, 4, 32, 64), "float32")
    kj, kt = _both(_normal(5, 1, 2, 80, 64), "float32")
    vj, vt = _both(_normal(6, 1, 2, 80, 64), "float32")
    out = flash_attention(qt, kt, vt, causal=causal, window=window,
                          q_offset=q_offset, scale=0.125)
    ref = jref.flash_attention_ref(qj, kj, vj, causal=causal, window=window,
                                   q_offset=q_offset, scale=0.125)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("hq,hkv,d", [(4, 4, 64), (8, 2, 64), (8, 1, 128)])
@pytest.mark.parametrize("valid", [1, 100, -1])
def test_decode_plain_matches_jax_and_pallas(dtype, tol, hq, hkv, d, valid):
    b, s = 2, 256
    qj, qt = _both(_normal(7, b, hq, d), dtype)
    kj, kt = _both(_normal(8, b, hkv, s, d), dtype)
    vj, vt = _both(_normal(9, b, hkv, s, d), dtype)
    vl = s if valid == -1 else valid
    out = decode_attention(qt, kt, vt, vl, scale=0.125)
    ref = jref.decode_attention_ref(qj, kj, vj, vl, scale=0.125)
    pallas = pallas_decode(qj, kj, vj, vl, scale=0.125, block_k=128,
                           interpret=True)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(out), _np(pallas), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("valid", [[1, 77, 128], [0, 5, 128], [128, 128, 1]])
def test_decode_plain_vector_valid_len(dtype, tol, valid):
    """A (B,) valid_len per row, as the engine's continuous batch has;
    valid_len 0 is the uniform mean of the row's V, as in the oracle."""
    b, hq, hkv, s, d = 3, 8, 2, 128, 64
    qj, qt = _both(_normal(10, b, hq, d), dtype)
    kj, kt = _both(_normal(11, b, hkv, s, d), dtype)
    vj, vt = _both(_normal(12, b, hkv, s, d), dtype)
    vl = np.asarray(valid, np.int32)
    out = decode_attention(qt, kt, vt, torch.from_numpy(vl), scale=0.125)
    ref = jref.decode_attention_ref(qj, kj, vj, jnp.asarray(vl), scale=0.125)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=tol, atol=tol)
    # each row equals the scalar-valid_len Pallas kernel on that row alone
    for i, n in enumerate(valid):
        row = pallas_decode(qj[i:i + 1], kj[i:i + 1], vj[i:i + 1], int(n),
                            scale=0.125, block_k=128, interpret=True)
        np.testing.assert_allclose(_np(out)[i:i + 1], _np(row), rtol=tol,
                                   atol=tol)


def test_ops_model_layout_matches_jax_ops():
    """(B, S, H, D) entry points: prefill and decode against the JAX ops
    wrappers, which run the Pallas kernels in interpret mode on the CPU."""
    from repro.kernels import ops as jops
    qj, qt = _both(_normal(13, 2, 64, 4, 64), "float32")
    kj, kt = _both(_normal(14, 2, 64, 2, 64), "float32")
    vj, vt = _both(_normal(15, 2, 64, 2, 64), "float32")
    out = ops.flash_attention(qt, kt, vt, window=16, scale=0.125)
    ref = jops.flash_attention(qj, kj, vj, window=16, scale=0.125)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=2e-5, atol=2e-5)
    out = ops.decode_attention(qt[:, :1], kt, vt, 40, scale=0.125)
    ref = jops.decode_attention(qj[:, :1], kj, vj, 40, scale=0.125)
    assert out.shape == (2, 1, 4, 64)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=2e-5, atol=2e-5)


def test_forcing_the_kernel_on_cpu_raises():
    q = torch.zeros(1, 8, 2, 64)
    k = torch.zeros(1, 8, 1, 64)
    with pytest.raises(RuntimeError, match="forced on a cpu tensor"):
        ops.flash_attention(q, k, k, force_kernel=True)
    with pytest.raises(RuntimeError, match="forced on a cpu tensor"):
        ops.decode_attention(q[:, :1], k, k, 4, force_kernel=True)
    # unforced, the same call takes the plain version
    assert ops.flash_attention(q, k, k).shape == q.shape


def test_cpu_path_counts_no_launch():
    ops.reset_launches()
    q = torch.zeros(1, 8, 2, 64)
    ops.flash_attention(q, q[:, :, :1], q[:, :, :1])
    ops.decode_attention(q[:, :1], q[:, :, :1], q[:, :, :1], 3)
    assert ops.kernel_launches() == {"flash_attention": 0,
                                     "decode_attention": 0}
