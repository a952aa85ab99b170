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
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mixtral-8x7b",
                                  "minicpm3-4b"])
def test_moe_and_mla_engines_run_on_the_kernels(cuda, arch):
    """Reduced MoE and MLA engines on the card: every prefill runs the flash
    kernel once a layer (MLA at head_dim 48), MoE decode runs the decode
    kernel, and MLA decode none (its decode is latent matrix products)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import ServingEngine

    cfg = get_config(arch).reduced(n_layers=2, d_model=128, vocab_size=512)
    eng = ServingEngine(cfg, init_params(cfg, device=cuda), max_batch=3,
                        max_seq=128, device=cuda)
    for i in range(4):
        eng.submit(list(range(5, 12 + i)), max_new_tokens=4)
    ops.reset_launches()
    done = eng.run_until_idle()
    assert len(done) == 4 and all(len(r.generated) == 4 for r in done)
    launches = ops.kernel_launches()
    assert launches["flash_attention"] == 4 * cfg.n_layers
    assert (launches["decode_attention"] > 0) == (cfg.mla is None)


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


# ---------------------------------------------------------------------------
# the bf16 tensor-core flash kernel and the split-KV decode kernel
# ---------------------------------------------------------------------------


def _rms_ok(out, ref):
    """Max error under 5% of the plain output's RMS: at long shapes |out| is
    about the bf16 tolerance, so allclose alone would pass a dropped tile."""
    err = (out.float() - ref.float()).abs().max().item()
    return err <= 0.05 * ref.float().pow(2).mean().sqrt().item()


@pytest.mark.gpu
@pytest.mark.parametrize("d", [48, 64, 96, 128, 256])
def test_tensor_core_selftest_one_tile(cuda, d):
    """One tile through the kernel's loaders, 128-byte swizzle, wgmma
    descriptors and both wgmma forms: S = Q.Kᵀ from shared memory, O =
    bf16(S).V with P from registers and V through the transpose bit; at D
    48 and 96 the tiles are zero-padded to 64 and 128 columns."""
    from repro_torch.kernels.flash_attention import tensor_core_selftest
    q, k, v = (torch.from_numpy(_normal(60 + i, 64, d) * 0.5).to(
        cuda, torch.bfloat16) for i in range(3))
    s, o = tensor_core_selftest(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(s, q.float() @ k.float().T, rtol=1e-4,
                               atol=1e-3)
    want = s.to(torch.bfloat16).float() @ v.float()
    torch.testing.assert_close(o, want, rtol=1e-4, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("window", [0, 16, 1024])
@pytest.mark.parametrize("sq", [4, 8, 40, 128, 1000])
@pytest.mark.parametrize("g", [1, 2, 8])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_tensor_core_sweep(cuda, d, g, sq, window):
    """bf16 prefill on the tensor-core kernel: GQA packing of g q-heads,
    ragged prompt buckets, windows, against the plain version."""
    hkv = 2
    q = torch.from_numpy(_normal(50, 1, g * hkv, sq, d)).to(cuda,
                                                           torch.bfloat16)
    k = torch.from_numpy(_normal(51, 1, hkv, sq, d)).to(cuda, torch.bfloat16)
    v = torch.from_numpy(_normal(52, 1, hkv, sq, d)).to(cuda, torch.bfloat16)
    before = flash_attention.launches
    out = flash_attention(q, k, v, window=window, scale=d ** -0.5)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = tref.flash_attention_ref(q, k, v, window=window, scale=d ** -0.5)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                               atol=2e-2)
    assert _rms_ok(out, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,window,q_offset", [
    (1, 8, 1, 40, 100, 256, 0, 60),       # a prefix-hit suffix
    (2, 4, 2, 128, 1000, 128, 0, 872),
    (1, 16, 8, 100, 300, 64, 64, 200),
    (1, 8, 1, 5, 200, 64, 0, 195),
    (1, 4, 4, 1000, 1000, 128, 0, 0),
    (1, 2, 1, 300, 700, 256, 1024, 400),
])
def test_flash_offsets_and_ragged_on_cuda(cuda, dtype, tol, b, hq, hkv, sq,
                                          sk, d, window, q_offset):
    """Sq != Sk with q_offset and long ragged rows: bf16 on the wgmma
    kernel, float32 on the 3xTF32 mma.sync kernel at 2e-5."""
    dt = TORCH_DT[dtype]
    q = torch.from_numpy(_normal(53, b, hq, sq, d)).to(cuda, dt)
    k = torch.from_numpy(_normal(54, b, hkv, sk, d)).to(cuda, dt)
    v = torch.from_numpy(_normal(55, b, hkv, sk, d)).to(cuda, dt)
    out = flash_attention(q, k, v, window=window, q_offset=q_offset,
                          scale=d ** -0.5)
    torch.cuda.synchronize()
    ref = tref.flash_attention_ref(q, k, v, window=window, q_offset=q_offset,
                                   scale=d ** -0.5)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    assert _rms_ok(out, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("d", [48, 96])
@pytest.mark.parametrize("b,hq,hkv,sq,sk,window,q_offset", [
    (1, 40, 40, 32, 32, 0, 0),        # minicpm3-4b's MLA prefill, bucket 32
    (1, 4, 4, 5, 5, 0, 0),            # reduced MLA, a ragged bucket
    (2, 8, 2, 40, 40, 16, 0),         # GQA, window
    (1, 8, 1, 33, 100, 0, 67),        # q_offset, ragged tiles
    (1, 4, 2, 300, 700, 64, 400),     # long ragged rows, window and offset
])
def test_flash_mla_head_dims_on_cuda(cuda, dtype, tol, d, b, hq, hkv, sq, sk,
                                     window, q_offset):
    """head_dim 48 and 96 (MLA's qk_nope + qk_rope): bf16 on the
    tensor-core kernel with its tiles padded to 64 and 128 columns in
    shared memory, float32 on the 3xTF32 kernel, both against the plain
    version, and again on strided views whose rows are wider than d."""
    dt = TORCH_DT[dtype]
    q = torch.from_numpy(_normal(70, b, hq, sq, d)).to(cuda, dt)
    k = torch.from_numpy(_normal(71, b, hkv, sk, d)).to(cuda, dt)
    v = torch.from_numpy(_normal(72, b, hkv, sk, d)).to(cuda, dt)
    out = flash_attention(q, k, v, window=window, q_offset=q_offset,
                          scale=d ** -0.5)
    torch.cuda.synchronize()
    ref = tref.flash_attention_ref(q, k, v, window=window, q_offset=q_offset,
                                   scale=d ** -0.5)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    assert _rms_ok(out, ref)
    # model layout (B, S, H, D) views into rows 32 columns wider, the extra
    # columns NaN: the loaders read the d real columns of each row only
    views = []
    for x in (q, k, v):
        wide = torch.full(x.shape[:3] + (d + 32,), float("nan"), device=cuda,
                          dtype=dt)
        wide[..., :d] = x
        views.append(wide.transpose(1, 2)[..., :d])
    got = ops.flash_attention(*views, window=window, q_offset=q_offset,
                              scale=d ** -0.5)
    torch.testing.assert_close(got.transpose(1, 2), out, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [48, 64, 96, 128, 256])
@pytest.mark.parametrize("b,hq,hkv,sq,sk,causal,window,q_offset", [
    (1, 8, 1, 32, 32, True, 0, 0),        # the serving path's bucket, G 8
    (2, 6, 2, 45, 77, True, 0, 32),       # ragged tiles, q_offset
    (1, 4, 4, 130, 130, True, 40, 0),     # window, ragged rows
    (1, 16, 1, 70, 200, True, 64, 130),   # G 16, window and offset
    (2, 4, 2, 100, 300, False, 0, 0),     # non-causal, Sq != Sk
    (1, 2, 1, 600, 600, True, 0, 0),      # many tiles, longest CTAs first
])
def test_flash_f32_tensor_core_kernel_on_cuda(cuda, d, b, hq, hkv, sq, sk,
                                              causal, window, q_offset):
    """The float32 kernel (3xTF32 on the tensor cores) against the plain
    version and against its own decomposition on the CPU
    (`flash_attention_tiled_ref`) at 2e-5, its logsumexp too, one launch a
    call; and on model-layout views whose rows are 32 columns wider than d
    (the extra columns NaN), the same output to the bit."""
    q = torch.from_numpy(_normal(160, b, hq, sq, d)).to(cuda)
    k = torch.from_numpy(_normal(161, b, hkv, sk, d)).to(cuda)
    v = torch.from_numpy(_normal(162, b, hkv, sk, d)).to(cuda)
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              scale=d ** -0.5)
    before = flash_attention.launches
    out, lse = flash_attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    plain, plain_lse = tref.flash_attention_lse_ref(q, k, v, **kw)
    torch.testing.assert_close(out, plain, rtol=2e-5, atol=2e-5)
    assert _rms_ok(out, plain)
    torch.testing.assert_close(lse, plain_lse, rtol=2e-5, atol=2e-5)
    tiled, tiled_lse = tref.flash_attention_tiled_ref(
        *(x.cpu() for x in (q, k, v)), **kw)
    torch.testing.assert_close(out.cpu(), tiled, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(lse.cpu(), tiled_lse, rtol=2e-5, atol=2e-5)
    views = []
    for x in (q, k, v):
        wide = torch.full(x.shape[:3] + (d + 32,), float("nan"), device=cuda)
        wide[..., :d] = x
        views.append(wide.transpose(1, 2)[..., :d])
    got = ops.flash_attention(*views, **kw)
    torch.testing.assert_close(got.transpose(1, 2), out, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [48, 64, 96, 128, 256])
def test_flash_f32_unaligned_operands_on_cuda(cuda, d):
    """Operands whose pointer is 4 bytes off a 16-byte boundary take the
    kernel's 4-byte copies: the same output as aligned copies of them."""
    b, hq, hkv, sq, sk = 1, 4, 2, 50, 90
    buf = torch.from_numpy(_normal(163, 3 * b * hq * sk * d + 1)).to(cuda)
    n_q, n_kv = b * hq * sq * d, b * hkv * sk * d
    q = buf[1:1 + n_q].view(b, hq, sq, d)
    k = buf[1 + n_q:1 + n_q + n_kv].view(b, hkv, sk, d)
    v = buf[1 + n_q + n_kv:1 + n_q + 2 * n_kv].view(b, hkv, sk, d)
    kw = dict(window=32, q_offset=40, scale=d ** -0.5)
    out = flash_attention(q, k, v, **kw)
    want = flash_attention(q.clone(), k.clone(), v.clone(), **kw)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    torch.testing.assert_close(
        out, tref.flash_attention_ref(q, k, v, **kw), rtol=2e-5, atol=2e-5)


@pytest.mark.gpu
def test_flash_bf16_long_sum_of_small_p(cuda):
    """Sk = 4096: P is rounded to bf16 before P.V, and many small P values
    are summed; the output stays within the bf16 tolerance and 5% of the
    RMS."""
    q = torch.from_numpy(_normal(56, 1, 8, 4096, 128)).to(cuda,
                                                         torch.bfloat16)
    k = torch.from_numpy(_normal(57, 1, 1, 4096, 128)).to(cuda,
                                                         torch.bfloat16)
    v = torch.from_numpy(_normal(58, 1, 1, 4096, 128)).to(cuda,
                                                         torch.bfloat16)
    out = flash_attention(q, k, v, scale=128 ** -0.5)
    ref = tref.flash_attention_ref(q, k, v, scale=128 ** -0.5)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                               atol=2e-2)
    assert _rms_ok(out, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("hq,hkv,d", [
    (8, 1, 128),
    # 10 and 16 q-heads a kv-head (recurrentgemma-2b: 10 on 1 at D 256):
    # bf16 fills both halves of the mma tile, float32 runs two sub-groups
    (10, 1, 128), (10, 1, 256), (20, 2, 256), (16, 1, 128), (16, 1, 256),
    (32, 2, 128),
])
@pytest.mark.parametrize("b", [1, 4, 32])
def test_decode_split_boundaries_on_cuda(cuda, dtype, tol, b, hq, hkv, d):
    """Split-KV decode where the splits behave differently: valid_len 0
    (every split masked: the uniform mean), 1, a multiple of the split
    length, one past it, S, and rows whose later splits are empty; one
    launch counted a call; the plain split-KV version with the wrapper's
    own split rule agrees."""
    from repro_torch.kernels.decode_attention import sm_count
    s = 1024
    n_split, split_len = tref.split_plan(s, b * hkv, sm_count(0))
    assert n_split > 1
    edges = [0, 1, split_len, split_len + 1, s, split_len - 1, 2 * split_len,
             s - 1]
    dt = TORCH_DT[dtype]
    q = torch.from_numpy(_normal(59, b, hq, d)).to(cuda, dt)
    k = torch.from_numpy(_normal(60, b, hkv, s, d)).to(cuda, dt)
    v = torch.from_numpy(_normal(61, b, hkv, s, d)).to(cuda, dt)
    for k0 in range(0, len(edges), b):
        valid = [edges[(i + k0) % len(edges)] for i in range(b)]
        vl = torch.tensor(valid, dtype=torch.int32, device=cuda)
        before = decode_attention.launches
        out = decode_attention(q, k, v, vl, scale=d ** -0.5)
        torch.cuda.synchronize()
        assert decode_attention.launches == before + 1   # one a call
        ref = tref.decode_attention_ref(q, k, v, vl, scale=d ** -0.5)
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol,
                                   atol=tol)
        split = tref.decode_attention_split_ref(q, k, v, vl, scale=d ** -0.5,
                                                sms=sm_count(0))
        torch.testing.assert_close(out.float(), split.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.gpu
def test_kernels_raise_on_misaligned_views(cuda):
    """The bf16 flash kernel and the decode kernel read 16-byte vectors: a
    view whose pointer or stride is not 16-byte aligned raises, it is not
    sent elsewhere."""
    buf = torch.zeros(1, 2, 64, 72, device=cuda, dtype=torch.bfloat16)
    odd = buf[..., 1:65]                 # pointer 2 bytes past alignment
    q = torch.zeros(1, 2, 64, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(q, odd, odd)
    with pytest.raises(ValueError, match="16-byte aligned"):
        decode_attention(q[:, :, 0], odd, odd, 3)
    strided = torch.zeros(1, 2, 64, 68, device=cuda,
                          dtype=torch.bfloat16)[..., :64]   # 136-byte rows
    with pytest.raises(ValueError, match="16-byte aligned"):
        decode_attention(q[:, :, 0], strided, strided, 3)


# ---------------------------------------------------------------------------
# the paged pool on the split-KV decode kernels, and the SSD kernel on the
# tensor cores
# ---------------------------------------------------------------------------


def _paged_pool(seed, b, hq, hkv, d, page, n_pages, dtype, cuda):
    """q, model-layout pools (n_pool, page, Hkv, D) and shuffled tables
    whose pad entry (the last of row 0) is page 0, which the last row also
    reads as its first page."""
    dt = TORCH_DT[dtype]
    n_pool = b * n_pages + 3
    q = torch.from_numpy(_normal(seed, b, hq, d)).to(cuda, dt)
    kp = torch.from_numpy(_normal(seed + 1, n_pool, page, hkv, d)).to(cuda, dt)
    vp = torch.from_numpy(_normal(seed + 2, n_pool, page, hkv, d)).to(cuda, dt)
    perm = np.random.default_rng(seed + 3).permutation(n_pool)[: b * n_pages]
    tables = torch.from_numpy(perm.reshape(b, n_pages).astype(np.int32))
    tables[-1, 0] = 0
    tables[0, -1] = 0
    return q, kp, vp, tables.to(cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("hq,d", [(8, 128), (10, 256), (16, 128)])
@pytest.mark.parametrize("b", [1, 4, 32])
def test_paged_split_boundaries_on_cuda(cuda, dtype, tol, b, hq, d):
    """Split-KV paged decode where splits and pages behave differently:
    valid_len 0 (every slot of the table, pad pages included: the uniform
    mean), 1, a split boundary and one past it, a page boundary and one
    past it, every slot, and rows whose later splits are empty; one launch
    counted a call; the plain split-KV paged version agrees; 8, 10 and 16
    q-heads on one kv-head."""
    from repro_torch.kernels.decode_attention import sm_count
    hkv, page, n_pages = 1, 16, 64
    span = page * n_pages
    n_split, split_len = tref.split_plan(span, b * hkv, sm_count(0))
    assert n_split > 1
    edges = [0, 1, split_len, split_len + 1, page, page + 1, span,
             split_len - 1, 2 * split_len, span - 1]
    q, kp, vp, tables = _paged_pool(70, b, hq, hkv, d, page, n_pages, dtype,
                                    cuda)
    kt, vt = kp.transpose(1, 2), vp.transpose(1, 2)
    for k0 in range(0, len(edges), b):
        valid = [edges[(i + k0) % len(edges)] for i in range(b)]
        vl = torch.tensor(valid, dtype=torch.int32, device=cuda)
        before = paged_attention.launches
        out = paged_attention(q, kt, vt, tables, vl, scale=d ** -0.5)
        torch.cuda.synchronize()
        assert paged_attention.launches == before + 1
        want = tref.paged_attention_ref(q, kt, vt, tables, vl,
                                        scale=d ** -0.5)
        torch.testing.assert_close(out.float(), want.float(), rtol=tol,
                                   atol=tol)
        assert _rms_ok(out, want)
        split = tref.paged_attention_split_ref(q, kt, vt, tables, vl,
                                               scale=d ** -0.5,
                                               sms=sm_count(0))
        torch.testing.assert_close(out.float(), split.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("d", [48, 80, 96])
def test_paged_odd_head_dims_valid_zero_on_cuda(cuda, dtype, tol, d):
    """head_dims 48, 80 and 96, which the decode wrapper does not take: bf16
    on the tensor-core kernel, float32 on the CUDA-core kernel with rows
    padded to a power of two; a row of valid_len 0 among them, and enough
    slots for several splits."""
    q, kp, vp, tables = _paged_pool(75, 4, 8, 2, d, 16, 48, dtype, cuda)
    vl = torch.tensor([0, 1, 700, 768], dtype=torch.int32, device=cuda)
    out = ops.paged_attention(q, kp, vp, tables, vl, scale=d ** -0.5,
                              force_kernel=True)
    torch.cuda.synchronize()
    want = tref.paged_attention_ref(q, kp.transpose(1, 2),
                                    vp.transpose(1, 2), tables, vl,
                                    scale=d ** -0.5)
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    assert _rms_ok(out, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,hq,hkv", [(64, 8, 2), (128, 16, 4), (256, 8, 1),
                                    (256, 10, 1), (128, 16, 1)])
def test_paged_and_dense_routes_agree_on_cuda(cuda, dtype, d, hq, hkv):
    """The paged route and the dense route are one kernel with two row
    policies: on the same slots, laid out through a shuffled page table or
    densely, they split alike and give the same output, bit for bit."""
    b, page, n_pages = 4, 16, 40
    q, kp, vp, tables = _paged_pool(80, b, hq, hkv, d, page, n_pages, dtype,
                                    cuda)
    kt, vt = kp.transpose(1, 2), vp.transpose(1, 2)
    vl = torch.tensor([0, 17, 512, 640], dtype=torch.int32, device=cuda)
    paged = paged_attention(q, kt, vt, tables, vl, scale=d ** -0.5)
    dense = decode_attention(q, tref.gather_pages(kt, tables),
                             tref.gather_pages(vt, tables), vl,
                             scale=d ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(paged, dense)


def _ssd_args(seed, b, s, h, p, n, cuda):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, s, h, p), np.float32))
    dt = torch.nn.functional.softplus(
        torch.from_numpy(rng.standard_normal((b, s, h), np.float32)) - 1)
    A = -torch.exp(torch.from_numpy(
        rng.standard_normal(h).astype(np.float32)) * 0.3)
    Bm = torch.from_numpy(rng.standard_normal((b, s, n), np.float32)) * 0.3
    Cm = torch.from_numpy(rng.standard_normal((b, s, n), np.float32)) * 0.3
    return [a.to(cuda) for a in (x, dt, A, Bm, Cm)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (1, 2048, 80, 64, 128, 256),   # mamba2-2.7b, a long prompt: 8 chunks
    (2, 512, 80, 64, 128, 256),
])
def test_ssd_diag_long_on_cuda(cuda, b, s, h, p, n, chunk):
    """Several chunks of 256: every chunk's score tiles and cum in the
    workspace, one launch counted a call; against the plain version at
    2e-5, and against the plain version of the kernel's own decomposition
    (tiled, 3xTF32)."""
    args = _ssd_args(34, b, s, h, p, n, cuda)
    before = ssd_diag.launches
    out = ssd_diag(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_diag.launches == before + 1
    torch.testing.assert_close(out, tref.ssd_diag_ref(*args, chunk=chunk),
                               rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(out, tref.ssd_diag_tiled_ref(*args,
                                                            chunk=chunk),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (1, 96, 33, 48, 24, 32),     # 33 heads: a second cum CTA of one head
    (2, 192, 7, 32, 16, 96),     # a chunk of 96: a ragged last q-tile
    (1, 24, 5, 18, 10, 8),       # P and N not multiples of 4: 4-byte copies
    (1, 128, 81, 64, 128, 128),  # one head past mamba2-2.7b's 80
    (3, 64, 2, 8, 12, 64),       # N not a multiple of 8: zero columns
])
def test_ssd_diag_odd_shapes_on_cuda(cuda, b, s, h, p, n, chunk):
    args = _ssd_args(35, b, s, h, p, n, cuda)
    before = ssd_diag.launches
    out = ops.ssd_diag(*args, chunk=chunk, force_kernel=True)
    torch.cuda.synchronize()
    assert ssd_diag.launches == before + 1
    torch.testing.assert_close(out, tref.ssd_diag_ref(*args, chunk=chunk),
                               rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# the RG-LRU hybrid (recurrentgemma-2b: 10 q-heads on 1 kv-head, D 256,
# window 2048) and M-RoPE (qwen2-vl-2b: 12 on 2, D 128) at their full
# widths' attention shapes
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,window,q_offset", [
    (1, 10, 1, 256, 256, 256, 2048, 0),    # recurrentgemma-2b, bucket 256
    (1, 10, 1, 37, 37, 256, 2048, 0),      # a ragged bucket
    (1, 10, 1, 2500, 2500, 256, 2048, 0),  # past the window
    (1, 10, 1, 40, 300, 256, 2048, 260),   # a prefix-hit suffix
    (1, 12, 2, 256, 256, 128, 0, 0),       # qwen2-vl-2b, bucket 256
    (1, 12, 2, 19, 19, 128, 0, 0),
    (2, 12, 2, 1000, 1000, 128, 0, 0),
])
def test_flash_rglru_and_mrope_shapes_on_cuda(cuda, dtype, tol, b, hq, hkv,
                                              sq, sk, d, window, q_offset):
    dt = TORCH_DT[dtype]
    q = torch.from_numpy(_normal(120, b, hq, sq, d)).to(cuda, dt)
    k = torch.from_numpy(_normal(121, b, hkv, sk, d)).to(cuda, dt)
    v = torch.from_numpy(_normal(122, b, hkv, sk, d)).to(cuda, dt)
    out = flash_attention(q, k, v, window=window, q_offset=q_offset,
                          scale=d ** -0.5)
    torch.cuda.synchronize()
    ref = tref.flash_attention_ref(q, k, v, window=window, q_offset=q_offset,
                                   scale=d ** -0.5)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    assert _rms_ok(out, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "qwen2-vl-2b"])
def test_rglru_and_mrope_engines_run_on_the_kernels(cuda, arch):
    """Reduced float32 hybrid and M-RoPE engines on the card: the flash
    kernel once an attention layer a prefill, the decode kernel once an
    attention layer a step, and the CPU's greedy tokens."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import ServingEngine

    cfg = dataclasses.replace(get_config(arch).reduced(
        n_layers=3, d_model=128, vocab_size=512), dtype="float32")
    params = init_params(cfg, device="cpu")
    n_attn = cfg.attention_layer_count()
    out = []
    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, dev) for v in tree]
        return tree.to(dev)

    for dev in (cuda, torch.device("cpu")):
        eng = ServingEngine(cfg, to(params, dev), max_batch=3, max_seq=64,
                            device=dev)
        for i in range(4):
            eng.submit(list(range(5, 12 + 3 * i)), max_new_tokens=5)
        ops.reset_launches()
        done = sorted(eng.run_until_idle(), key=lambda r: r.rid)
        launches = ops.kernel_launches()
        if dev.type == "cuda":
            assert launches["flash_attention"] == 4 * n_attn
            steps = launches["decode_attention"] // n_attn
            assert steps > 0 and launches["decode_attention"] == steps * n_attn
        out.append([r.generated for r in done])
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# the encoder-decoder family (whisper-base: 8 heads of 64, 1500 frames) and
# training: non-causal flash, its logsumexp, the kernels' autograd Functions
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("b,hq,hkv,sq,sk", [
    (2, 8, 8, 1, 1500),       # cross attention at decode
    (2, 8, 8, 32, 1500),      # cross attention at prefill
    (1, 8, 8, 1500, 1500),    # the encoder: a ragged last tile of 28 keys
    (1, 4, 2, 77, 1000),      # GQA, ragged query and key tails
])
def test_flash_noncausal_on_cuda(cuda, dtype, tol, d, b, hq, hkv, sq, sk):
    dt = TORCH_DT[dtype]
    q = torch.from_numpy(_normal(130, b, hq, sq, d)).to(cuda, dt)
    k = torch.from_numpy(_normal(131, b, hkv, sk, d)).to(cuda, dt)
    v = torch.from_numpy(_normal(132, b, hkv, sk, d)).to(cuda, dt)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=False, scale=d ** -0.5)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = tref.flash_attention_ref(q, k, v, causal=False, scale=d ** -0.5)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    assert _rms_ok(out, ref)


LSE_TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
           "bfloat16": dict(rtol=1e-4, atol=1e-3)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,window", [
    (1, 8, 1, 32, 32, 256, True, 0),       # gemma-2b's serving path
    (4, 8, 1, 256, 256, 256, True, 0),     # gemma-2b's training shape
    (1, 8, 8, 1500, 1500, 64, False, 0),   # whisper's encoder
    (2, 8, 8, 1, 1500, 64, False, 0),      # cross attention at decode
    (1, 16, 8, 40, 40, 256, True, 16),     # window, GQA, ragged
    (1, 2, 2, 16, 16, 48, True, 0),        # MLA's D 48, padded tiles
])
def test_flash_lse_on_cuda(cuda, dtype, b, hq, hkv, sq, sk, d, causal,
                           window):
    """The kernel's logsumexp against the plain one (bf16: the scores come
    from the tensor cores and exp2 in hardware, to about 1e-5 of their
    size), and the same output as a launch without it."""
    dt = TORCH_DT[dtype]
    q = torch.from_numpy(_normal(140, b, hq, sq, d)).to(cuda, dt)
    k = torch.from_numpy(_normal(141, b, hkv, sk, d)).to(cuda, dt)
    v = torch.from_numpy(_normal(142, b, hkv, sk, d)).to(cuda, dt)
    kw = dict(causal=causal, window=window, scale=d ** -0.5)
    out, lse = flash_attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    plain, plain_lse = tref.flash_attention_lse_ref(q, k, v, **kw)
    assert lse.shape == (b, hq, sq) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, plain_lse, **LSE_TOL[dtype])
    assert torch.equal(out, flash_attention(q, k, v, **kw))


def _grad_inputs(seed, b, hq, hkv, sq, sk, d, dt, cuda):
    """Model-layout (B, S, H, D) leaves that require a gradient, and the
    output gradient."""
    return ([torch.from_numpy(_normal(seed + i, b, s, h, d)).to(cuda, dt)
             .requires_grad_(True)
             for i, (s, h) in enumerate(((sq, hq), (sk, hkv), (sk, hkv)))],
            torch.from_numpy(_normal(seed + 3, b, sq, hq, d)).to(cuda, dt))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,window", [
    (4, 8, 1, 256, 256, 256, True, 0),     # gemma-2b's training shape
    (2, 8, 8, 300, 300, 64, False, 0),     # whisper's encoder, ragged
    (2, 8, 8, 32, 300, 64, False, 0),      # whisper's cross attention
    (1, 16, 8, 96, 96, 128, True, 32),     # window, GQA
    (1, 4, 4, 700, 700, 64, True, 0),      # two backward blocks
])
def test_flash_fn_grads_on_cuda(cuda, dtype, tol, b, hq, hkv, sq, sk, d,
                                causal, window):
    """FlashAttentionFn on the card (the kernel forward with its logsumexp,
    counted; the FlashAttention-2 backward) against autograd through the
    plain version on the same tensors."""
    dt = TORCH_DT[dtype]
    ins, dout = _grad_inputs(150, b, hq, hkv, sq, sk, d, dt, cuda)
    kw = dict(causal=causal, window=window, scale=d ** -0.5)
    before = flash_attention.launches
    out = ops.flash_attention(*ins, **kw)
    assert flash_attention.launches == before + 1
    got = torch.autograd.grad(out, ins, dout)
    plain = tref.flash_attention_ref(*(t.transpose(1, 2) for t in ins), **kw)
    want = torch.autograd.grad(plain, ins, dout.transpose(1, 2))
    for g, w in zip(got, want, strict=True):
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol)
        assert _grad_rms_ok(g, w)


def _grad_rms_ok(g, w):
    """`_rms_ok` less one output ulp an element: both gradients are summed
    in float32 and rounded once to the inputs' dtype, and a gradient's
    largest values are over ten times its RMS (the first causal rows see
    few keys), so a bf16 rounding that falls the other way is ~9% of the
    RMS by itself. What is left beyond that ulp must stay under 5%."""
    w = w.float()
    ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w).exponent
                      - (8 if g.dtype == torch.bfloat16 else 24))
    excess = ((g.float() - w).abs() - ulp).clamp(min=0).max().item()
    return excess <= 0.05 * w.pow(2).mean().sqrt().item()


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,p,n,chunk", [(2, 64, 8, 32, 16, 32),
                                             (1, 256, 80, 64, 128, 256)])
def test_ssd_fn_grads_on_cuda(cuda, b, s, h, p, n, chunk):
    """SSDDiagFn on the card: the kernel forward (counted), the plain
    version's gradient."""
    args = [t.requires_grad_(True) for t in _ssd_args(36, b, s, h, p, n, cuda)]
    before = ssd_diag.launches
    y = ops.ssd_diag(*args, chunk=chunk)
    assert ssd_diag.launches == before + 1
    dy = torch.from_numpy(_normal(37, b, s, h, p)).to(cuda)
    got = torch.autograd.grad(y, args, dy)
    want = torch.autograd.grad(tref.ssd_diag_ref(*args, chunk=chunk), args,
                               dy)
    for g, w in zip(got, want, strict=True):
        torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-5)


def _to(tree, dev):
    """A copy of the tree's tensors on `dev` (training updates in place)."""
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev, copy=True)


def _reduced_f32(arch):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32")


@pytest.mark.gpu
def test_backward_sets_every_gradient_on_cuda(cuda):
    """loss.backward() on the card fills wq, wk and wv of every layer (the
    kernel's forward alone has no grad_fn) with the CPU's gradients."""
    from repro_torch.models import dummy_batch, init_params, loss_fn
    cfg = _reduced_f32("gemma-2b")
    params = init_params(cfg, seed=0, device="cpu")
    batch = dummy_batch(torch.Generator().manual_seed(1), cfg, 2, 32)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        p = _to(params, dev)
        leaves = [t.requires_grad_(True) for layer in p["layers"]
                  for t in layer["mix"].values()]
        ops.reset_launches()
        total, _ = loss_fn(p, _to(batch, dev), cfg=cfg)
        total.backward()
        if dev.type == "cuda":
            assert ops.kernel_launches()["flash_attention"] == cfg.n_layers
        assert all(t.grad is not None and t.grad.abs().sum() > 0
                   for t in leaves)
        grads.append([t.grad.cpu() for t in leaves])
    for g, w in zip(*grads, strict=True):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_whisper_tokens_card_vs_cpu(cuda):
    """A reduced float32 whisper at the model level: the card's greedy
    tokens are the CPU's, with the flash kernel once an encoder, decoder
    self and cross layer a prefill and once a cross layer a decode step, and
    the decode kernel once a decoder layer a step."""
    from repro_torch.models import init_params
    from repro_torch.models.model import greedy_generate
    cfg = _reduced_f32("whisper-base")
    params = init_params(cfg, seed=0, device="cpu")
    prompts = [[(7 * i + j) % cfg.vocab_size for j in range(n)]
               for i, n in enumerate((4, 9, 17))]
    frames = torch.from_numpy(_normal(160, 3, cfg.encoder_seq_len,
                                      cfg.d_model))
    out = []
    for dev in (cuda, torch.device("cpu")):
        ops.reset_launches()
        out.append(greedy_generate(
            _to(params, dev), prompts, cfg=cfg, steps=6, max_seq=64,
            extras={"audio_frames": frames.to(dev)}))
        if dev.type == "cuda":
            n = cfg.n_layers
            launches = ops.kernel_launches()
            assert launches["flash_attention"] == 3 * 3 * n + 6 * n
            assert launches["decode_attention"] == 6 * n
    assert out[0] == out[1]


TRAIN_ARCHS = ["gemma-2b", "gemma3-12b", "mamba2-2.7b", "deepseek-moe-16b",
               "mixtral-8x7b", "minicpm3-4b", "recurrentgemma-2b",
               "qwen2-vl-2b", "whisper-base"]


@pytest.mark.gpu
@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_steps_card_vs_cpu(cuda, arch, microbatches):
    """Three AdamW steps of a reduced float32 model on the card and on the
    CPU from the same weights and batches: losses within 1e-4, parameters
    within 5e-3 (the JAX tests' step tolerance), the kernels on the card."""
    from repro_torch.models import dummy_batch, init_params
    from repro_torch.training import (
        AdamWConfig, init_opt_state, make_train_step,
    )
    from repro_torch.training.optimizer import leaves
    cfg = _reduced_f32(arch)
    params = init_params(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(2)
    batches = [dummy_batch(gen, cfg, 2, 32) for _ in range(3)]
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1),
                           microbatches=microbatches)
    runs = []
    for dev in (cuda, torch.device("cpu")):
        p = _to(params, dev)
        state = init_opt_state(p)
        ops.reset_launches()
        losses = []
        for batch in batches:
            p, state, m = step(p, state, _to(batch, dev))
            losses.append(float(m["loss"]))
        if dev.type == "cuda":
            launches = ops.kernel_launches()
            kernel = "ssd_diag" if cfg.family == "ssm" else "flash_attention"
            assert launches[kernel] > 0
        runs.append((losses, [t.cpu() for t in leaves(p)]))
    (card_loss, card_p), (cpu_loss, cpu_p) = runs
    np.testing.assert_allclose(card_loss, cpu_loss, rtol=1e-4, atol=1e-4)
    assert all(np.isfinite(card_loss))
    for a, b in zip(card_p, cpu_p, strict=True):
        torch.testing.assert_close(a, b, rtol=5e-3, atol=5e-3)


# the decode kernel's logsumexp (the context-parallel decode's shard
# partial): float32 to 2e-5; bf16 scores come from the tensor cores, to
# about 1e-5 of their size (the flash kernel's gate)
DECODE_LSE_TOL = {"float32": 2e-5, "bfloat16": 1e-3}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("g", [1, 4, 10, 16])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("s", [256, 1024, 4096])
def test_decode_lse_matches_plain_logsumexp(cuda, dtype, tol, g, d, s):
    """Rows of 0, 1, about half of S and S valid slots, in one split (S =
    256) or across split boundaries (1024 and 4096 split the cache at
    these 4 rows), against the plain logsumexp; a row with no valid slot
    gets -1e30 + log(S), which weighs zero."""
    hkv = 2
    valid = [0, 1, min(300, s // 2 + 3), s]
    b = len(valid)
    dt = TORCH_DT[dtype]
    q = torch.tensor(_normal(31, b, g * hkv, d), device=cuda).to(dt)
    k = torch.tensor(_normal(32, b, hkv, s, d), device=cuda).to(dt)
    v = torch.tensor(_normal(33, b, hkv, s, d), device=cuda).to(dt)
    vl = torch.tensor(valid, dtype=torch.int32, device=cuda)
    scale = d ** -0.5
    out, lse = decode_attention(q, k, v, vl, scale=scale, return_lse=True)
    plain, plain_lse = tref.decode_attention_lse_ref(q, k, v, vl, scale=scale)
    torch.testing.assert_close(out.float(), plain.float(), rtol=tol,
                               atol=tol)
    live = vl > 0
    err = (lse - plain_lse)[live].abs().max().item()
    assert err <= DECODE_LSE_TOL[dtype] * max(
        1.0, plain_lse[live].abs().max().item())
    assert bool((lse[~live] <= -1e29).all())
    # serving launches without lse: the same rows
    torch.testing.assert_close(decode_attention(q, k, v, vl, scale=scale),
                               out, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("hq,hkv,d", [(8, 1, 256), (16, 4, 128)])
def test_cp_combine_matches_whole_cache_decode(cuda, dtype, tol, shards, hq,
                                               hkv, d):
    """The context-parallel decode on the card: the decode kernel with its
    logsumexp over each slice of the cache, combined, against the plain
    decode of the whole cache (a shard past a row's length weighs zero)."""
    s = 512
    valid = [1, 129, 300, 512]
    b = len(valid)
    dt = TORCH_DT[dtype]
    q = torch.tensor(_normal(41, b, hq, d), device=cuda).to(dt)
    k = torch.tensor(_normal(42, b, hkv, s, d), device=cuda).to(dt)
    v = torch.tensor(_normal(43, b, hkv, s, d), device=cuda).to(dt)
    vl = torch.tensor(valid, dtype=torch.int32, device=cuda)
    scale = d ** -0.5
    sl = s // shards
    outs, lses = [], []
    for i in range(shards):
        o, lse = decode_attention(
            q, k[:, :, i * sl:(i + 1) * sl], v[:, :, i * sl:(i + 1) * sl],
            torch.clamp(vl - i * sl, 0, sl).to(torch.int32), scale=scale,
            return_lse=True)
        outs.append(o)
        lses.append(lse)
    got = tref.cp_combine_ref(outs, lses)
    want = tref.decode_attention_ref(q, k, v, vl, scale=scale)
    torch.testing.assert_close(got, want.float(), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# the paper's deployment models and the gemma3 family at their full widths'
# attention shapes, which reduced configs (4 q-heads of 64) never reach:
# llama2-33b 52 on 52 (MHA) and llama2-7b 32 on 32, yi 32 on 4 (8 a
# kv-head), llama3-8b 32 on 8, gemma3-12b 16 on 8 at D 256 with its
# 1024-slot window, gemma3-27b 32 on 16 at D 128
# ---------------------------------------------------------------------------


def _row_rms_ok(out, ref):
    """Each row's max error under 5% of that row's RMS in the plain output.
    A dropped tile moves a row by about its RMS; a bf16 rounding tie does
    not, though on a large early-row output it can pass 5% of the whole
    tensor's RMS (32 on 16 heads at S 1024: a -1.98828 that the kernel
    rounds to -1.984375 and the plain version to -1.9921875, 6.4% of the
    tensor's RMS, 3.1% of its row's, each as far from the float32 result)."""
    err = (out.float() - ref.float()).abs().amax(-1)
    rms = ref.float().pow(2).mean(-1).sqrt()
    return bool((err <= 0.05 * rms).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,window,q_offset", [
    (1, 52, 52, 32, 32, 128, 0, 0),          # llama2-33b, bucket 32
    (1, 52, 52, 1000, 1000, 128, 0, 0),
    (1, 32, 32, 16, 16, 128, 0, 0),          # llama2-7b
    (1, 32, 4, 32, 32, 128, 0, 0),           # yi-6b / yi-9b
    (2, 32, 4, 700, 700, 128, 0, 0),
    (1, 32, 8, 23, 23, 128, 0, 0),           # llama3-8b
    (1, 16, 8, 2048, 2048, 256, 1024, 0),    # gemma3-12b local, bucket 2048
    (1, 16, 8, 1024, 1024, 256, 1024, 0),    # the window fills the bucket
    (1, 16, 8, 2048, 2048, 256, 0, 0),       # gemma3-12b global
    (1, 32, 16, 2048, 2048, 128, 1024, 0),   # gemma3-27b local
    (1, 32, 16, 1024, 1024, 128, 0, 0),      # gemma3-27b global
])
def test_flash_deployment_shapes_on_cuda(cuda, dtype, tol, b, hq, hkv, sq,
                                         sk, d, window, q_offset):
    dt = TORCH_DT[dtype]
    q = torch.from_numpy(_normal(130, b, hq, sq, d)).to(cuda, dt)
    k = torch.from_numpy(_normal(131, b, hkv, sk, d)).to(cuda, dt)
    v = torch.from_numpy(_normal(132, b, hkv, sk, d)).to(cuda, dt)
    out = flash_attention(q, k, v, window=window, q_offset=q_offset,
                          scale=d ** -0.5)
    torch.cuda.synchronize()
    ref = tref.flash_attention_ref(q, k, v, window=window, q_offset=q_offset,
                                   scale=d ** -0.5)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    assert _row_rms_ok(out, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("hq,hkv,s,d,valid", [
    (52, 52, 256, 128, [9, 1, 40, 256]),       # llama2-33b
    (32, 32, 256, 128, [23, 256, 0, 17]),      # llama2-7b
    (32, 4, 256, 128, [100, 50, 1, 7]),        # yi
    (32, 8, 256, 128, [4, 255, 128, 64]),      # llama3-8b
    # gemma3-12b: a rolling local cache of 1024 slots, every row past the
    # window (valid_len 1024) or not yet; its global layer at 2048 slots
    (16, 8, 1024, 256, [1024, 1024, 1, 700]),
    (16, 8, 2048, 256, [2048, 1100, 1900, 1]),
    (32, 16, 1024, 128, [1024, 513, 1, 1024]),  # gemma3-27b local
])
def test_decode_deployment_shapes_on_cuda(cuda, dtype, tol, hq, hkv, s, d,
                                          valid):
    dt = TORCH_DT[dtype]
    b = len(valid)
    q = torch.from_numpy(_normal(133, b, hq, d)).to(cuda, dt)
    k = torch.from_numpy(_normal(134, b, hkv, s, d)).to(cuda, dt)
    v = torch.from_numpy(_normal(135, b, hkv, s, d)).to(cuda, dt)
    vl = torch.tensor(valid, dtype=torch.int32, device=cuda)
    before = decode_attention.launches
    out = decode_attention(q, k, v, vl, scale=d ** -0.5)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    ref = tref.decode_attention_ref(q, k, v, vl, scale=d ** -0.5)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,max_seq,lengths", [
    ("llama2-33b", 128, [5, 23, 40]),
    ("yi-9b", 128, [5, 23, 40]),
    # past the 1024-slot window: a prompt in the 2048 bucket is prefilled
    # into the window's last slots, one in the 1024 bucket rolls at decode
    ("gemma3-12b", 2048, [1017, 1100]),
    ("gemma3-27b", 2048, [1017, 1100]),
])
def test_deployment_heads_engine_card_vs_cpu(cuda, arch, max_seq, lengths):
    """The full config's heads, head_dim and window on a narrow float32
    model (d_model 256, 6 layers, vocab 512): the engine's greedy tokens on
    the card equal the CPU's, with flash once a layer a prefill and decode
    once a layer a step."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import ServingEngine

    cfg = dataclasses.replace(get_config(arch), n_layers=6, d_model=256,
                              d_ff=512, vocab_size=512, dtype="float32")
    params = init_params(cfg, device="cpu")

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, dev) for v in tree]
        return tree.to(dev)

    out = []
    for dev in (cuda, torch.device("cpu")):
        eng = ServingEngine(cfg, to(params, dev), max_batch=2,
                            max_seq=max_seq, device=dev)
        for i, n in enumerate(lengths):
            eng.submit([(7 * i + 3 * j + 1) % 512 for j in range(n)],
                       max_new_tokens=12)
        ops.reset_launches()
        done = sorted(eng.run_until_idle(), key=lambda r: r.rid)
        launches = ops.kernel_launches()
        if dev.type == "cuda":
            assert launches["flash_attention"] == len(lengths) * 6
            assert launches["decode_attention"] == eng.n_decode_steps * 6
        out.append([r.generated for r in done])
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# the engine's prefill graphs: each bucket's batch-1 prefill captured at its
# first prefill and replayed after, against `prefill` called eagerly
# ---------------------------------------------------------------------------

GRAPH_MAX_SEQ = 128
# buckets 8, 16, 32 and 128 (gemma3's window 64 rolls there), each met twice
# or more, so that every bucket replays
GRAPH_LENGTHS = [5, 7, 12, 14, 30, 20, 70, 100, 6]


def _graph_weights(arch, dtype, cuda):
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    cfg = dataclasses.replace(get_config(arch).reduced(
        n_layers=2, d_model=128, vocab_size=512), dtype=dtype)
    return cfg, init_params(cfg, seed=0, device=cuda)


def _spy_prefill_logits(monkeypatch):
    """The logits each prefill of an engine of 2+ slots samples, in
    admission order (a decode step's have a row a slot)."""
    from repro_torch.serving import engine as E
    seen, real = [], E.sample_tokens

    def spy(logits, *args, **kw):
        if logits.shape[0] == 1:
            seen.append(logits.clone())
        return real(logits, *args, **kw)

    monkeypatch.setattr(E, "sample_tokens", spy)
    return seen


def _eager_prefill(cfg, params, prompt, max_seq, cuda, moe_dispatch="dense"):
    """`prefill` called directly, as the eager engine calls it: the prompt
    right-padded to its bucket, a fresh batch-1 cache, the head on its last
    row."""
    from repro_torch.models import model as M
    n = len(prompt)
    bucket = min(1 << max(n - 1, 1).bit_length(), max_seq)
    batch = {"tokens": torch.tensor([prompt + [0] * (bucket - n)],
                                    device=cuda)}
    if cfg.mrope:
        batch["positions"] = torch.arange(bucket, device=cuda).expand(
            3, 1, bucket)
    logits, _ = M.prefill(params, batch, M.init_cache(cfg, 1, max_seq,
                                                      device=cuda),
                          cfg=cfg, last=n - 1, moe_dispatch=moe_dispatch)
    return logits


@pytest.mark.gpu
@pytest.mark.parametrize("arch,dtype,dispatch", [
    ("yi-6b", "float32", "dense"),
    ("yi-6b", "bfloat16", "dense"),
    ("gemma-2b", "bfloat16", "dense"),          # the scaled embedding
    ("gemma3-12b", "bfloat16", "dense"),        # window 64 rolls at 128
    ("mamba2-2.7b", "bfloat16", "dense"),
    ("deepseek-moe-16b", "bfloat16", "dense"),
    ("deepseek-moe-16b", "bfloat16", "capacity"),
    ("minicpm3-4b", "bfloat16", "dense"),       # MLA
    ("qwen2-vl-2b", "bfloat16", "dense"),       # M-RoPE
    ("recurrentgemma-2b", "bfloat16", "dense"),
])
def test_graphed_prefill_equals_eager_prefill(cuda, monkeypatch, arch, dtype,
                                              dispatch):
    """Every family the engine serves prefills through its bucket graphs on
    the card: a capture at each bucket's first prefill, replays after, no
    eager prefill; each prefill's logits equal `prefill` called eagerly bit
    for bit, and so its first token."""
    from repro_torch.serving import ServingEngine

    cfg, params = _graph_weights(arch, dtype, cuda)
    seen = _spy_prefill_logits(monkeypatch)
    eng = ServingEngine(cfg, params, max_batch=3, max_seq=GRAPH_MAX_SEQ,
                        device=cuda, moe_dispatch=dispatch)
    prompts = [[(11 * i + 5 * j + 1) % 512 for j in range(n)]
               for i, n in enumerate(GRAPH_LENGTHS)]
    reqs = [eng.submit(p, max_new_tokens=4) for p in prompts]
    eng.run_until_idle()
    m = eng.metrics
    buckets = len(eng._graphs)
    assert buckets == 4 == eng.prefill_compiles
    assert m.get("engine.prefill_graph_captures") == buckets
    assert m.get("engine.prefill_graph_replays") == len(prompts) - buckets
    assert m.get("engine.prefill_eager") == 0
    assert len(seen) == len(prompts)
    for prompt, req, got in zip(prompts, reqs, seen, strict=True):
        want = _eager_prefill(cfg, params, prompt, GRAPH_MAX_SEQ, cuda,
                              dispatch)
        assert torch.equal(got, want), (len(prompt),
                                        (got - want).abs().max().item())
        assert req.generated[0] == int(want.argmax())


@pytest.mark.gpu
def test_graphed_prefill_resets_the_static_cache(cuda):
    """A 2048-token prompt and then a 40-token one replayed in the same slot
    give the 40-token prompt a fresh engine's tokens, and the slot's rows
    past its bucket hold zeros: the graph's reset of the static batch-1
    cache holds."""
    from repro_torch.serving import ServingEngine

    cfg, params = _graph_weights("yi-6b", "bfloat16", cuda)

    def prompt(n, k):
        return [(k * 13 + 7 * j + 1) % 512 for j in range(n)]

    eng = ServingEngine(cfg, params, max_batch=1, max_seq=4096, device=cuda)
    for p in (prompt(40, 1), prompt(2000, 2)):      # captures 64 and 2048
        eng.submit(p, max_new_tokens=3)
        eng.run_until_idle()
    req = eng.submit(prompt(40, 3), max_new_tokens=6)
    eng.run_until_idle()
    assert eng.metrics.get("engine.prefill_graph_replays") == 1
    fresh = ServingEngine(cfg, params, max_batch=1, max_seq=4096,
                          device=cuda)
    ref = fresh.submit(prompt(40, 3), max_new_tokens=6)
    fresh.run_until_idle()
    assert req.generated == ref.generated
    # the prefill wrote the 64 bucket (its padding too), decode up to 45
    for layer in eng.cache:
        assert layer["k"][0, :64].any()
        assert not layer["k"][0, 64:].any()
        assert not layer["v"][0, 64:].any()


@pytest.mark.gpu
def test_graph_replay_advances_the_launch_counters(cuda):
    """The kernel launch counters count a replayed prefill's kernels: what
    the bucket's capture recorded (flash once a layer; the SSD kernel once
    a layer for mamba2), while the capture itself counts nothing."""
    from repro_torch.serving import ServingEngine

    for arch, kernel in (("yi-6b", "flash_attention"),
                         ("mamba2-2.7b", "ssd_diag")):
        cfg, params = _graph_weights(arch, "bfloat16", cuda)
        eng = ServingEngine(cfg, params, max_batch=2, max_seq=64,
                            device=cuda)
        ops.reset_launches()
        eng.submit(list(range(3, 15)), max_new_tokens=1)     # captures 16
        eng.run_until_idle()
        assert ops.kernel_launches()[kernel] == cfg.n_layers
        assert eng._graphs[16].launches[kernel] == cfg.n_layers
        ops.reset_launches()
        eng.submit(list(range(5, 18)), max_new_tokens=1)     # replays 16
        eng.run_until_idle()
        assert eng.metrics.get("engine.prefill_graph_replays") == 1
        assert ops.kernel_launches()[kernel] == cfg.n_layers
        assert ops.kernel_launches()["decode_attention"] == 0


@pytest.mark.gpu
def test_paged_engine_stores_the_prefix_of_a_graphed_prefill(cuda):
    """A paged engine publishes a replayed prefill's blocks from the static
    batch-1 cache; a later prompt that shares them decodes its suffix from
    those pages and ends with the tokens of an engine without sharing."""
    from repro_torch.serving import ServingEngine

    cfg, params = _graph_weights("gemma-2b", "float32", cuda)
    head = [(5 * j + 2) % 512 for j in range(32)]
    prompts = [[(3 * j + 1) % 512 for j in range(35)],   # captures 64
               head + [9, 10, 11],                       # replays 64
               head + [12]]                              # hits head
    out = []
    for sharing in (True, False):
        eng = ServingEngine(cfg, params, max_batch=1, max_seq=128,
                            device=cuda, paged=True, kv_block_tokens=16,
                            prefix_sharing=sharing)
        reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
        eng.run_until_idle()
        out.append([r.generated for r in reqs])
        if sharing:
            assert eng.n_prefix_hits == 1
            assert eng.metrics.get("engine.prefill_graph_replays") == 1
    assert out[0] == out[1]


@pytest.mark.gpu
def test_profiler_sees_the_kernels_of_a_replay(cuda):
    """Graphs captured before the profiler's first start (as a server warms
    its buckets before anyone traces it): the trace of a replayed prefill
    holds one graph launch, not a launch a kernel, and the kernels inside
    it under their own names."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import ServingEngine

    cfg, params = _graph_weights("yi-6b", "bfloat16", cuda)
    eng = ServingEngine(cfg, params, max_batch=2, max_seq=64, device=cuda)
    eng.submit(list(range(3, 15)), max_new_tokens=1)         # captures 16
    eng.run_until_idle()
    eng.submit(list(range(5, 18)), max_new_tokens=1)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng._admit()                                         # replays 16
        torch.cuda.synchronize()
    assert eng.metrics.get("engine.prefill_graph_replays") == 1
    events = list(prof.profiler.kineto_results.events())
    host = [e.name() for e in events
            if not str(e.device_type()).endswith("CUDA")]
    device = [e.name() for e in events
              if str(e.device_type()).endswith("CUDA")]
    assert host.count("cudaGraphLaunch") == 1
    # the token read's few launches beside it; eagerly, ~80 a layer
    assert host.count("cudaLaunchKernel") < 10
    assert sum("flash_tc_kernel" in n for n in device) == cfg.n_layers
