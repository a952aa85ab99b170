"""The port on a card: each CUDA kernel against its plain version, and the
engine's main path through the kernels. Every test here needs a CUDA card
and skips elsewhere; the file imports no JAX, so it runs on a machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention

DTYPES = [("float32", 2e-5), ("bfloat16", 2e-2)]
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, np.float32)


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never at import time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,window,q_offset", [
    (1, 8, 1, 8, 8, 256, 0, 0),       # gemma-2b MQA, a bucket of 8
    (2, 8, 1, 32, 32, 256, 0, 0),
    (1, 16, 8, 40, 40, 256, 16, 0),   # gemma3 GQA, window, ragged tile
    (2, 4, 2, 70, 70, 128, 64, 0),
    (1, 2, 2, 33, 50, 64, 0, 17),     # q_offset, ragged KV tile
    (1, 2, 1, 4, 4, 64, 0, 0),        # the fleet's engines, bucket 4
    (1, 2, 1, 16, 16, 64, 64, 0),     # the fleet's cloud local layer
])
def test_flash_kernel_matches_plain_on_cuda(cuda, dtype, tol, b, hq, hkv, sq,
                                            sk, d, window, q_offset):
    dt = TORCH_DT[dtype]
    q = torch.from_numpy(_normal(20, b, hq, sq, d)).to(cuda, dt)
    k = torch.from_numpy(_normal(21, b, hkv, sk, d)).to(cuda, dt)
    v = torch.from_numpy(_normal(22, b, hkv, sk, d)).to(cuda, dt)
    before = flash_attention.launches
    out = flash_attention(q, k, v, window=window, q_offset=q_offset,
                          scale=d ** -0.5)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = tref.flash_attention_ref(q, k, v, window=window, q_offset=q_offset,
                                   scale=d ** -0.5)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("hq,hkv,s,d,valid", [
    (8, 1, 256, 256, [9, 1, 40, 256]),   # gemma-2b MQA, ragged rows
    (16, 8, 128, 256, [0, 128, 3, 64]),
    (32, 4, 100, 128, [100, 50, 1, 7]),
    (4, 4, 64, 64, [64, 64, 64, 64]),
    (2, 1, 64, 64, [5, 12, 0, 64]),      # the fleet's engines
])
def test_decode_kernel_matches_plain_on_cuda(cuda, dtype, tol, hq, hkv, s, d,
                                             valid):
    dt = TORCH_DT[dtype]
    b = len(valid)
    q = torch.from_numpy(_normal(23, b, hq, d)).to(cuda, dt)
    k = torch.from_numpy(_normal(24, b, hkv, s, d)).to(cuda, dt)
    v = torch.from_numpy(_normal(25, b, hkv, s, d)).to(cuda, dt)
    vl = torch.tensor(valid, dtype=torch.int32, device=cuda)
    out = decode_attention(q, k, v, vl, scale=d ** -0.5)
    torch.cuda.synchronize()
    ref = tref.decode_attention_ref(q, k, v, vl, scale=d ** -0.5)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
def test_ops_model_layout_on_cuda(cuda):
    """Views of (B, S, H, D) tensors reach the kernels without a copy."""
    q = torch.from_numpy(_normal(26, 2, 24, 8, 256)).to(cuda)
    kv = torch.from_numpy(_normal(27, 2, 64, 1, 256)).to(cuda)
    out = ops.flash_attention(q, kv[:, :24], kv[:, :24], scale=0.0625,
                              force_kernel=True)
    ref = tref.flash_attention_ref(q.transpose(1, 2),
                                   kv[:, :24].transpose(1, 2),
                                   kv[:, :24].transpose(1, 2), scale=0.0625)
    torch.testing.assert_close(out, ref.transpose(1, 2), rtol=2e-5,
                               atol=2e-5)
    vl = torch.tensor([5, 64], dtype=torch.int32, device=cuda)
    out = ops.decode_attention(q[:, :1], kv, kv, vl, scale=0.0625,
                               force_kernel=True)
    ref = tref.decode_attention_ref(q[:, 0], kv.transpose(1, 2),
                                    kv.transpose(1, 2), vl, scale=0.0625)
    torch.testing.assert_close(out[:, 0], ref, rtol=2e-5, atol=2e-5)


@pytest.mark.gpu
def test_engine_runs_on_the_kernels(cuda):
    """A reduced gemma-2b engine on the card serves every request, and its
    prefill and decode go through the two kernels."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import ServingEngine

    cfg = get_config("gemma-2b").reduced(n_layers=2, d_model=128,
                                         vocab_size=512)
    eng = ServingEngine(cfg, init_params(cfg, device=cuda), max_batch=3,
                        max_seq=128, device=cuda)
    for i in range(5):
        eng.submit(list(range(5, 12 + i)), max_new_tokens=4)
    ops.reset_launches()
    done = eng.run_until_idle()
    assert len(done) == 5 and all(len(r.generated) == 4 for r in done)
    launches = ops.kernel_launches()
    assert launches["flash_attention"] == 5 * cfg.n_layers
    assert launches["decode_attention"] > 0
