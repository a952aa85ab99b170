"""The port's Mamba-2 family against the JAX package on identical weights:
the SSD kernel's plain version, the chunked SSD scan, the model (forward,
prefill, decode) and the serving engine's greedy tokens.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: 2e-5 for the SSD diagonal block (float32, as the JAX kernel
test pins it); 1e-4 for the chunked scan and the model's float32 logits,
because the two frameworks sum each einsum and matrix product in different
orders.
"""
import dataclasses

import jax  # noqa: F401  (both packages in one process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import config_pair, numpy_tree, weights_pair
from repro.configs import get_config as jax_get_config
from repro.kernels.ssd_diag import ssd_diag as pallas_ssd_diag
from repro.models import cpu_context
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import prefill as jax_prefill
from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro.serving import ServingEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.ssd_diag import ssd_diag
from repro_torch.models import (
    decode_step, forward, init_cache, init_params, prefill,
)
from repro_torch.models.convert import cache_from_jax
from repro_torch.models.ssm import ssd_chunked
from repro_torch.models.transformer import block_program
from repro_torch.serving import ServingEngine

TOL = dict(rtol=1e-4, atol=1e-4)
CTX = cpu_context(remat=False)
ARCH = "mamba2-2.7b"


def _ssd_inputs(seed, b, s, h, p, n):
    """The distributions of tests/test_kernels.py's SSD test, from numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h), np.float32) - 1))
    A = -np.exp(rng.standard_normal(h).astype(np.float32) * 0.3)
    Bm = rng.standard_normal((b, s, n), np.float32) * 0.3
    Cm = rng.standard_normal((b, s, n), np.float32) * 0.3
    return [a.astype(np.float32) for a in (x, dt, A, Bm, Cm)]


def _normal_f32(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, np.float32)


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s), np.int32)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j),
                               **(tol or TOL))


# ---------------------------------------------------------------------------
# the SSD diagonal block and the chunked scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [
    (2, 64, 4, 8, 16, 16), (1, 256, 2, 64, 128, 128), (2, 128, 8, 32, 64, 64),
])
def test_ssd_diag_plain_matches_pallas(shape):
    """The plain version (what a CPU tensor runs) against the JAX package's
    Pallas kernel in interpret mode, at the shapes of its own test."""
    b, s, h, p, n, chunk = shape
    arrs = _ssd_inputs(0, b, s, h, p, n)
    out = ssd_diag(*(torch.from_numpy(a) for a in arrs), chunk=chunk)
    pallas = pallas_ssd_diag(*(jnp.asarray(a) for a in arrs), chunk=chunk,
                             interpret=True)
    assert out.shape == (b, s, h, p) and out.dtype == torch.float32
    _close(out, pallas, rtol=2e-5, atol=2e-5)
    # the model-layout entry point is the same function
    out2 = ops.ssd_diag(*(torch.from_numpy(a) for a in arrs), chunk=chunk)
    torch.testing.assert_close(out2, out, rtol=0, atol=0)


@pytest.mark.parametrize("shape", [
    (2, 64, 4, 8, 16, 16), (1, 256, 2, 64, 128, 128), (2, 128, 8, 32, 64, 64),
    (2, 64, 4, 8, 16, 8), (1, 48, 5, 16, 32, 16), (1, 192, 3, 32, 16, 96),
])
def test_ssd_diag_tiled_plain_matches_pallas(shape):
    """The kernel's decomposition on the CPU (C·Bᵀ once a chunk in 64-row
    tiles, the causal tile pairs only, sequential cum, both products in
    3xTF32) against the JAX package's Pallas kernel in interpret mode at
    2e-5: at the shapes of its own test, at chunks 8 and 16, and at a chunk
    of 96 (a ragged last q-tile) with 3 heads."""
    b, s, h, p, n, chunk = shape
    arrs = _ssd_inputs(4, b, s, h, p, n)
    out = tref.ssd_diag_tiled_ref(*(torch.from_numpy(a) for a in arrs),
                                 chunk=chunk)
    pallas = pallas_ssd_diag(*(jnp.asarray(a) for a in arrs), chunk=chunk,
                             interpret=True)
    assert out.shape == (b, s, h, p) and out.dtype == torch.float32
    _close(out, pallas, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("s", [256, 512])
def test_ssd_diag_tiled_plain_at_mamba2_width(s):
    """At mamba2-2.7b's width (80 heads of 64, state 128, chunk 256) the
    tiled 3xTF32 form against the plain version within 1e-3 of the output's
    RMS, the measure chip_smoke.py holds the kernel to across summation
    orders: cum reaches about -80 there, so the plain version's cumsum,
    which takes another order, moves the decay by a few float32 ulps of
    80."""
    arrs = [torch.from_numpy(a) for a in _ssd_inputs(5, 1, s, 80, 64, 128)]
    out = tref.ssd_diag_tiled_ref(*arrs, chunk=256)
    plain = tref.ssd_diag_ref(*arrs, chunk=256)
    rms = plain.pow(2).mean().sqrt().item()
    assert rms > 0
    assert (out - plain).abs().max().item() <= 1e-3 * rms


def test_tf32_round_keeps_ten_mantissa_bits():
    """`tf32_round` clears the low 13 bits and rounds to the nearest (ties
    away from zero); a 3xTF32 product keeps float32 accuracy where one TF32
    product does not."""
    x = torch.from_numpy(_normal_f32(6, 4096))
    r = tref.tf32_round(x)
    assert (r.view(torch.int32) & 0x1FFF).eq(0).all()
    assert ((x - r).abs() <= x.abs() * 2.0 ** -11).all()
    ties = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])
    assert tref.tf32_round(ties).tolist() == [1.0 + 2.0 ** -10,
                                             -(1.0 + 2.0 ** -10)]
    a = torch.from_numpy(_normal_f32(7, 64, 128))
    bm = torch.from_numpy(_normal_f32(8, 128, 64))
    exact = a.double() @ bm.double()
    scale = (a.double().abs() @ bm.double().abs()).max().item()
    err3 = (tref.mm_3xtf32(a, bm).double() - exact).abs().max().item()
    err1 = (tref.tf32_round(a) @ tref.tf32_round(bm) - exact).abs().max().item()
    assert err3 <= 1e-6 * scale < err1


def test_ssd_diag_rejects_a_chunk_that_does_not_divide():
    arrs = [torch.from_numpy(a) for a in _ssd_inputs(1, 1, 24, 2, 8, 16)]
    with pytest.raises(ValueError, match="must divide"):
        ssd_diag(*arrs, chunk=16)
    with pytest.raises(ValueError, match="must divide"):
        tref.ssd_diag_tiled_ref(*arrs, chunk=16)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("s,chunk", [(64, 16), (40, 16), (8, 8), (128, 32),
                                     (96, 32), (16, 16)])
def test_ssd_chunked_matches_jax(use_pallas, s, chunk):
    """The port's chunked scan (the diagonal block from one `ssd_diag` call
    after the loop, on the CPU its plain version) against the JAX scan with
    and without its Pallas kernel; S = 40 pads the last chunk."""
    arrs = _ssd_inputs(2, 2, s, 4, 16, 8)
    y, state = ssd_chunked(*(torch.from_numpy(a) for a in arrs), chunk)
    jy, jstate = jax_ssd_chunked(*(jnp.asarray(a) for a in arrs), chunk,
                                 use_pallas=use_pallas)
    assert y.shape == (2, s, 4, 16) and state.shape == (2, 4, 16, 8)
    _close(y, jy)
    _close(state, jstate)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_block_program_is_one_ssm_layer_per_layer():
    _, tcfg = config_pair(ARCH)
    prog = block_program(tcfg)
    assert [s.kind for s in prog.layers()] == ["ssm"] * tcfg.n_layers
    cache = init_cache(tcfg, 3, 64, device="cpu")
    s = tcfg.ssm
    di, nh = s.d_inner(tcfg.d_model), s.n_heads(tcfg.d_model)
    assert cache[0]["state"].shape == (3, nh, s.head_dim, s.d_state)
    assert cache[0]["state"].dtype == torch.float32
    assert cache[0]["conv"].shape == (3, s.d_conv - 1, di + 2 * s.d_state)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_forward_logits_match_jax(use_pallas):
    jcfg, tcfg = config_pair(ARCH)
    jp, tp = weights_pair(jcfg, tcfg)
    toks = _tokens(0, 2, 40, jcfg.vocab_size)    # 40: a padded last chunk
    jl, _, _ = jax_forward(jp, {"tokens": jnp.asarray(toks)}, cfg=jcfg,
                           ctx=cpu_context(remat=False, use_pallas=use_pallas),
                           mode="train")
    tl, _ = forward(tp, {"tokens": torch.from_numpy(toks).long()}, cfg=tcfg,
                    mode="train")
    assert tl.shape == (2, 40, jcfg.vocab_size) and tl.dtype == torch.float32
    _close(tl, jl)


def test_prefill_and_decode_match_jax():
    """Prefill fills the same SSM and conv states; decode steps then give
    the JAX logits and states."""
    jcfg, tcfg = config_pair(ARCH)
    jp, tp = weights_pair(jcfg, tcfg)
    toks = _tokens(1, 2, 24, jcfg.vocab_size)
    jc = jax_init_cache(jcfg, 2, 64)
    tc = init_cache(tcfg, 2, 64, device="cpu")
    jlast, jc = jax_prefill(jp, {"tokens": jnp.asarray(toks[:, :20])}, jc,
                            cfg=jcfg, ctx=CTX)
    tlast, tc = prefill(tp, {"tokens": torch.from_numpy(toks[:, :20]).long()},
                        tc, cfg=tcfg)
    _close(tlast, jlast)
    for tl, jl in zip(tc, cache_from_jax(numpy_tree(jc), tcfg, "cpu"),
                      strict=True):
        assert tl.keys() == jl.keys() == {"state", "conv"}
        for key in tl:
            _close(tl[key], jl[key].numpy())
    for t in range(20, 24):
        jl, jc = jax_decode_step(jp, jnp.asarray(toks[:, t:t + 1]), jc,
                                 jnp.int32(t), cfg=jcfg, ctx=CTX)
        tl, tc = decode_step(tp, torch.from_numpy(toks[:, t:t + 1]).long(),
                             tc, t, cfg=tcfg)
        _close(tl, jl)
    for tl, jl in zip(tc, cache_from_jax(numpy_tree(jc), tcfg, "cpu"),
                      strict=True):
        _close(tl["state"], jl["state"].numpy())


def test_prefill_decode_matches_forward():
    """Prefill of S-1 tokens then one decode step == the full forward's
    last two positions (the recurrent form equals the chunked one)."""
    _, tcfg = config_pair(ARCH)
    tp = init_params(tcfg, seed=3, device="cpu")
    toks = torch.from_numpy(_tokens(4, 2, 33, tcfg.vocab_size)).long()
    full, _ = forward(tp, {"tokens": toks}, cfg=tcfg, mode="train")
    cache = init_cache(tcfg, 2, 64, device="cpu")
    last, cache = prefill(tp, {"tokens": toks[:, :32]}, cache, cfg=tcfg)
    torch.testing.assert_close(last, full[:, 31], **TOL)
    logits, _ = decode_step(tp, toks[:, 32:], cache, 32, cfg=tcfg)
    torch.testing.assert_close(logits, full[:, 32], **TOL)


def test_init_params_matches_jax_layout():
    """`init_params` draws its own bits but has the JAX tree's layout and
    dtypes, and its SSM parameters lie in the JAX ranges."""
    jcfg, tcfg = config_pair(ARCH)
    _, ref = weights_pair(jcfg, tcfg)
    got = init_params(tcfg, seed=0, device="cpu")
    assert len(got["layers"]) == len(ref["layers"]) == tcfg.n_layers
    for g_layer, r_layer in zip(got["layers"], ref["layers"], strict=True):
        assert g_layer.keys() == r_layer.keys() == {"norm1", "mix"}
        gm, rm = g_layer["mix"], r_layer["mix"]
        assert gm.keys() == rm.keys()
        for key in gm:
            if key == "norm":
                assert torch.equal(gm[key]["scale"], rm[key]["scale"])
                continue
            assert gm[key].shape == rm[key].shape, key
            assert gm[key].dtype == rm[key].dtype, key
        step = torch.nn.functional.softplus(gm["dt_bias"])
        assert bool(((step > 0.001 - 1e-6) & (step < 0.1 + 1e-6)).all())
        a = torch.exp(gm["A_log"])
        assert bool(((a >= 1.0) & (a <= 16.0)).all())
        assert torch.equal(gm["D"], torch.ones_like(gm["D"]))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _engines(max_batch=3, max_seq=64, **kw):
    jcfg, tcfg = config_pair(ARCH)
    jp, tp = weights_pair(jcfg, tcfg)
    return (JaxEngine(jcfg, jp, max_batch=max_batch, max_seq=max_seq, **kw),
            ServingEngine(tcfg, tp, max_batch=max_batch, max_seq=max_seq,
                          device="cpu", **kw))


def test_engine_greedy_tokens_match_jax_engine():
    """Prompts of 5, 7, 11, 13, 19 and 29 tokens (none a power of two):
    the pad tokens of each prefill bucket run through the recurrence into
    the SSM and conv states, in the JAX engine and in the port alike, so
    the tokens match only if the port keeps that behaviour."""
    je, te = _engines()
    lengths = (5, 7, 11, 13, 19, 29)
    for i, n in enumerate(lengths):
        p = [(11 * i + 3 * j) % 512 for j in range(n)]
        je.submit(p, max_new_tokens=6)
        te.submit(p, max_new_tokens=6)
    jd = sorted(je.run_until_idle(), key=lambda r: r.rid)
    td = sorted(te.run_until_idle(), key=lambda r: r.rid)
    assert [r.generated for r in td] == [r.generated for r in jd]
    assert all(len(r.generated) == 6 for r in td)
    assert te.stats() == je.stats()


def test_padded_prefill_differs_from_exact_prefill():
    """The bucket padding is visible: an exact-length prefill of a 5-token
    prompt decodes other tokens than the engine's bucket-8 prefill does
    (the reference's behaviour; see ROADMAP §3)."""
    _, te = _engines(max_batch=1)
    prompt = [(7 * j + 1) % 512 for j in range(5)]
    r = te.submit(prompt, max_new_tokens=4)
    te.run_until_idle()
    cfg, params = te.cfg, te.params
    cache = init_cache(cfg, 1, 64, device="cpu")
    logits, cache = prefill(params, {"tokens": torch.tensor([prompt])},
                            cache, cfg=cfg)
    toks = [int(logits.argmax(-1))]
    for t in range(3):
        logits, cache = decode_step(params, torch.tensor([[toks[-1]]]),
                                    cache, 5 + t, cfg=cfg)
        toks.append(int(logits.argmax(-1)))
    assert toks[0] == r.generated[0]
    assert toks != r.generated


def test_paged_engine_evict_resubmit_keeps_the_ssm_state():
    """A paged Mamba-2 engine has no paged leaves: its SSM and conv states
    go whole through the `KVSnapshot`. Evict mid-decode and resubmit: the
    same tokens as an uninterrupted run and as the JAX engine doing the
    same, with one prefill."""
    je, te = _engines(max_batch=2, paged=True, kv_block_tokens=16)
    assert not te.kv.supports_prefix and te.kv.prefix is None
    ref_eng = _engines(max_batch=2)[1]
    prompts = [[(5 * j + 2) % 512 for j in range(n)] for n in (9, 14)]
    for p in prompts:
        ref_eng.submit(p, max_new_tokens=10)
    ref = [r.generated for r in sorted(ref_eng.run_until_idle(),
                                       key=lambda r: r.rid)]
    outs = []
    for eng in (je, te):
        reqs = [eng.submit(p, max_new_tokens=10) for p in prompts]
        for _ in range(4):
            eng.step()
        victim = eng.evict(reqs[0].slot)
        assert victim is reqs[0] and victim.kv is not None
        eng.step()
        eng.resubmit(victim)
        eng.run_until_idle()
        assert eng.n_prefills == 2
        assert eng.kv.free_blocks == eng.kv.n_blocks
        outs.append([r.generated for r in reqs])
    assert outs[1] == outs[0] == ref


def test_full_width_config_is_the_jax_one():
    """The width chip_smoke.py serves: 80 heads of 64, state 128, chunk
    256, as in the JAX package's config."""
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.vocab_size) == (64, 2560, 50280)
    assert cfg.ssm.n_heads(cfg.d_model) == 80 and cfg.ssm.head_dim == 64
    assert cfg.ssm.d_state == 128 and cfg.ssm.chunk_size == 256
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_get_config(ARCH))
