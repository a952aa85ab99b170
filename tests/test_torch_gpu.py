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
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.ssd_diag import ssd_diag

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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("hq,hkv,d,page,n_pages,valid", [
    (8, 1, 256, 16, 4, [20, 27, 0, 64]),   # gemma-2b MQA, the engine's page
    (8, 2, 64, 16, 8, [0, 57, 128]),
    (8, 2, 48, 16, 8, [1, 100]),
    (8, 2, 80, 16, 8, [128, 5]),
    (4, 4, 128, 32, 4, [128, 77, 1]),
    (2, 1, 64, 64, 2, [7, 128]),
])
def test_paged_kernel_matches_plain_on_cuda(cuda, dtype, tol, hq, hkv, d,
                                            page, n_pages, valid):
    """Shuffled tables, a pad entry on page 0 aliasing a live page, ragged
    valid lengths with 0 among them; the pools are views of the model
    layout (n_pool, page, Hkv, D)."""
    dt = TORCH_DT[dtype]
    b = len(valid)
    n_pool = b * n_pages + 3
    q = torch.from_numpy(_normal(28, b, hq, d)).to(cuda, dt)
    kp = torch.from_numpy(_normal(29, n_pool, page, hkv, d)).to(cuda, dt)
    vp = torch.from_numpy(_normal(30, n_pool, page, hkv, d)).to(cuda, dt)
    perm = np.random.default_rng(31).permutation(n_pool)[: b * n_pages]
    tables = torch.from_numpy(perm.reshape(b, n_pages).astype(np.int32))
    tables[0, -1] = 0
    tables = tables.to(cuda)
    vl = torch.tensor(valid, dtype=torch.int32, device=cuda)
    before = paged_attention.launches
    out = ops.paged_attention(q, kp, vp, tables, vl, scale=d ** -0.5,
                              force_kernel=True)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    ref = tref.paged_attention_ref(q, kp.transpose(1, 2), vp.transpose(1, 2),
                                   tables, vl, scale=d ** -0.5)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    # a scalar valid_len is every row's
    out = paged_attention(q, kp.transpose(1, 2), vp.transpose(1, 2), tables,
                          9, scale=d ** -0.5)
    ref = tref.paged_attention_ref(q, kp.transpose(1, 2), vp.transpose(1, 2),
                                   tables, 9, scale=d ** -0.5)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 64, 4, 8, 16, 16),
    (1, 256, 2, 64, 128, 128),
    (2, 128, 8, 32, 64, 64),
    (1, 256, 80, 64, 128, 256),   # mamba2-2.7b width, the 256 bucket
    (1, 32, 80, 64, 128, 32),     # the 32 bucket
    (1, 8, 80, 64, 128, 8),       # the 8 bucket
])
def test_ssd_diag_kernel_matches_plain_on_cuda(cuda, b, s, h, p, n, chunk):
    rng = np.random.default_rng(32)
    x = torch.from_numpy(rng.standard_normal((b, s, h, p), np.float32))
    dt = torch.nn.functional.softplus(
        torch.from_numpy(rng.standard_normal((b, s, h), np.float32)) - 1)
    A = -torch.exp(torch.from_numpy(
        rng.standard_normal(h).astype(np.float32)) * 0.3)
    Bm = torch.from_numpy(rng.standard_normal((b, s, n), np.float32)) * 0.3
    Cm = torch.from_numpy(rng.standard_normal((b, s, n), np.float32)) * 0.3
    args = [a.to(cuda) for a in (x, dt, A, Bm, Cm)]
    before = ssd_diag.launches
    out = ops.ssd_diag(*args, chunk=chunk, force_kernel=True)
    torch.cuda.synchronize()
    assert ssd_diag.launches == before + 1
    ref = tref.ssd_diag_ref(*args, chunk=chunk)
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)


@pytest.mark.gpu
def test_mamba2_engine_runs_on_the_kernel(cuda):
    """A reduced mamba2 engine on the card serves every request, and every
    prefill runs the SSD-diagonal kernel once per layer."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import ServingEngine

    cfg = get_config("mamba2-2.7b").reduced(n_layers=2, d_model=128,
                                            vocab_size=512)
    eng = ServingEngine(cfg, init_params(cfg, device=cuda), max_batch=3,
                        max_seq=128, device=cuda)
    for i in range(5):
        eng.submit(list(range(5, 12 + 7 * i)), max_new_tokens=4)
    ops.reset_launches()
    done = eng.run_until_idle()
    assert len(done) == 5 and all(len(r.generated) == 4 for r in done)
    launches = ops.kernel_launches()
    assert launches["ssd_diag"] == eng.n_prefills * cfg.n_layers
    assert launches["flash_attention"] == launches["decode_attention"] == 0


@pytest.mark.gpu
def test_paged_engine_resumes_on_cuda(cuda):
    """A reduced paged gemma-2b engine on the card: evict mid-decode,
    resubmit, and the request ends with the dense engine's tokens; the
    paged kernel on the pool equals decode on the dense slot cache."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import ServingEngine

    cfg = get_config("gemma-2b").reduced(n_layers=2, d_model=128,
                                         vocab_size=512)
    params = init_params(cfg, device=cuda)
    prompt = list(range(3, 37))
    dense = ServingEngine(cfg, params, max_batch=1, max_seq=128, device=cuda)
    ref = dense.submit(prompt, max_new_tokens=10)
    dense.run_until_idle()
    eng = ServingEngine(cfg, params, max_batch=1, max_seq=128, device=cuda,
                        paged=True, kv_block_tokens=16)
    req = eng.submit(prompt, max_new_tokens=10)
    for _ in range(4):
        eng.step()
    slot_cache = eng._extract_slot(req.slot)
    eng.evict(req.slot)
    pos = req.kv.position
    table = torch.tensor([req.pages.blocks], dtype=torch.int32, device=cuda)
    for layer in range(cfg.n_layers):
        kp, vp = eng.kv.pool_views(layer)
        q = torch.from_numpy(_normal(33, 1, 2, 64)).to(cuda, kp.dtype)
        tol = dict(DTYPES)[str(kp.dtype).removeprefix("torch.")]
        got = ops.paged_attention(q, kp, vp, table, pos, force_kernel=True)
        want = ops.decode_attention(q, slot_cache[layer]["k"],
                                    slot_cache[layer]["v"], pos,
                                    force_kernel=True)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
    eng.resubmit(req)
    eng.run_until_idle()
    assert req.generated == ref.generated and eng.n_prefills == 1


@pytest.mark.gpu
def test_paged_kernel_rejects_pages_outside_the_pool(cuda):
    q = torch.zeros(1, 2, 64, device=cuda)
    pool = torch.zeros(4, 1, 16, 64, device=cuda)
    with pytest.raises(ValueError, match="outside the pool"):
        paged_attention(q, pool, pool, torch.tensor([[0, 4]], device=cuda), 8)


@pytest.mark.gpu
def test_paged_kernel_without_the_page_check_is_the_same_launch(cuda):
    """`check_pages=False` skips only the host check: the same output, bit
    for bit, and one launch counted per call either way."""
    q = torch.from_numpy(_normal(40, 2, 4, 64)).to(cuda)
    pool = torch.from_numpy(_normal(41, 6, 2, 16, 64)).to(cuda)
    tables = torch.tensor([[3, 1], [5, 0]], dtype=torch.int32, device=cuda)
    vl = torch.tensor([20, 0], dtype=torch.int32, device=cuda)
    ops.reset_launches()
    checked = paged_attention(q, pool, pool, tables, vl)
    unchecked = paged_attention(q, pool, pool, tables, vl, check_pages=False)
    assert torch.equal(checked, unchecked)
    assert ops.kernel_launches()["paged_attention"] == 2
