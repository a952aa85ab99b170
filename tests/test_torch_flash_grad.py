"""Gradients through the kernels on the training path, on the CPU.

`FlashAttentionFn` (the plain forward with its logsumexp here, the
FlashAttention-2 backward) against ``jax.grad`` through the JAX package's
``attn_op`` (plain sdpa up to 2048 positions, the ``flash_jnp`` custom VJP
above) and against torch autograd through the plain version; `SSDDiagFn`
against autograd through its plain version. Inputs from numpy, float32;
tolerance 2e-5 absolute and relative, the f32 kernel tolerance of
tests/test_kernels.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import cpu_context
from repro.models import layers as JL
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels.ssd_diag import SSDDiagFn

TOL = dict(rtol=2e-5, atol=2e-5)
CTX = cpu_context(remat=False)

# (b, hq, hkv, sq, sk, d, causal, window, q_offset)
CASES = [
    (2, 4, 4, 64, 64, 64, True, 0, 0),          # causal
    (1, 4, 2, 96, 96, 64, True, 32, 0),         # window, GQA
    (2, 4, 1, 40, 40, 128, True, 0, 0),         # MQA
    (1, 2, 2, 33, 77, 64, False, 0, 0),         # non-causal, cross-shaped
    (1, 4, 2, 1, 1500, 64, False, 0, 0),        # cross decode: Sq 1
    (1, 2, 2, 1500, 1500, 64, False, 0, 0),     # ragged 1500: 3 blocks
    (1, 2, 1, 600, 600, 48, True, 0, 0),        # causal over two blocks
    (1, 2, 2, 20, 40, 64, True, 0, 20),         # q_offset
]
IDS = ["causal", "window-gqa", "mqa", "noncausal", "cross-sq1", "ragged1500",
       "causal-blocks", "q_offset"]


def _inputs(case, seed=0):
    b, hq, hkv, sq, sk, d = case[:6]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d),
                      (b, sq, hq, d))]


def _port_grads(q, k, v, do, causal, window, q_offset, scale):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = ops.flash_attention(*ts, causal=causal, window=window,
                              q_offset=q_offset, scale=scale)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(do))
    return out, grads


def _close(t, a):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(a), **TOL)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_flash_fn_grads_match_jax(case):
    causal, window, q_offset = case[6:]
    q, k, v, do = _inputs(case)
    scale = case[5] ** -0.5

    def f(q, k, v):
        out = JL.attn_op(q, k, v, causal=causal, window=window, scale=scale,
                         q_offset=q_offset, ctx=CTX)
        return jnp.sum(out * do), out

    (_, jout), jg = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out, grads = _port_grads(q, k, v, do, causal, window, q_offset, scale)
    _close(out, jout)
    for g, w in zip(grads, jg, strict=True):
        _close(g, w)


def test_flash_fn_grads_match_jax_flash_jnp():
    """Above 2048 positions the JAX attn_op runs `flash_jnp`, whose custom
    VJP is the FlashAttention-2 backward the port's reproduces."""
    case = (1, 2, 1, 2560, 2560, 64, True, 0, 0)
    q, k, v, do = _inputs(case, seed=1)
    scale = 0.125

    def f(q, k, v):
        return jnp.sum(JL.attn_op(q, k, v, causal=True, window=0, scale=scale,
                                  ctx=CTX) * do)

    jg = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v))
    _, grads = _port_grads(q, k, v, do, True, 0, 0, scale)
    for g, w in zip(grads, jg, strict=True):
        _close(g, w)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_flash_fn_grads_match_plain_autograd(case):
    causal, window, q_offset = case[6:]
    q, k, v, do = _inputs(case, seed=2)
    scale = case[5] ** -0.5
    _, grads = _port_grads(q, k, v, do, causal, window, q_offset, scale)
    ts = [torch.from_numpy(a).transpose(1, 2).requires_grad_(True)
          for a in (q, k, v)]
    out = ref.flash_attention_ref(*ts, causal=causal, window=window,
                                  q_offset=q_offset, scale=scale)
    want = torch.autograd.grad(out, ts, torch.from_numpy(do).transpose(1, 2))
    for g, w in zip(grads, want, strict=True):
        torch.testing.assert_close(g, w.transpose(1, 2), **TOL)


@pytest.mark.parametrize("case", CASES[:6], ids=IDS[:6])
def test_lse_matches_jax_flash_forward(case):
    """The plain version's logsumexp is `_flash_fwd_impl`'s ``lse``
    (``m + log(max(l, 1e-30))``), which the kernel writes on the card."""
    b, hq, hkv, sq, sk, d, causal, window, q_offset = case
    q, k, v, _ = _inputs(case, seed=3)
    jout, jlse = JL._flash_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, window,
        d ** -0.5, q_offset, sq, sk)
    out, lse = ref.flash_attention_lse_ref(
        *(torch.from_numpy(a).transpose(1, 2) for a in (q, k, v)),
        causal=causal, window=window, q_offset=q_offset, scale=d ** -0.5)
    assert lse.shape == (b, hq, sq) and lse.dtype == torch.float32
    _close(lse, np.asarray(jlse).reshape(b, hq, sq))
    _close(out.transpose(1, 2), jout)
    plain = ref.flash_attention_ref(
        *(torch.from_numpy(a).transpose(1, 2) for a in (q, k, v)),
        causal=causal, window=window, q_offset=q_offset, scale=d ** -0.5)
    torch.testing.assert_close(out, plain, **TOL)


def test_wrapper_returns_lse_on_the_cpu():
    q = torch.randn(1, 2, 5, 64)
    out, lse = fa.flash_attention(q, q, q, scale=0.125, return_lse=True)
    torch.testing.assert_close(out, fa.flash_attention(q, q, q, scale=0.125))
    assert lse.shape == (1, 2, 5)


def test_flash_fn_only_where_a_gradient_is_wanted(monkeypatch):
    """ops.flash_attention takes the autograd Function only when grad mode
    is on and an input requires a gradient: serving calls the wrapper as it
    did, with no logsumexp."""
    calls = []
    real = fa.flash_attention

    def spy(*a, **kw):
        calls.append(kw.get("return_lse", False))
        return real(*a, **kw)

    monkeypatch.setattr(fa, "flash_attention", spy)
    q = torch.randn(1, 8, 2, 64)
    ops.flash_attention(q, q, q)
    with torch.no_grad():
        ops.flash_attention(q.requires_grad_(), q, q)
    out = ops.flash_attention(q, q, q)
    assert out.requires_grad and out.grad_fn is not None
    assert calls == [False, False, True]


def _ssd_inputs(b, s, h, p, n, seed=4):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, s, h, p, generator=g)
    dt = torch.nn.functional.softplus(torch.randn(b, s, h, generator=g) - 1)
    A = -torch.exp(torch.randn(h, generator=g) * 0.3)
    Bm = torch.randn(b, s, n, generator=g) * 0.3
    Cm = torch.randn(b, s, n, generator=g) * 0.3
    return [t.requires_grad_(True) for t in (x, dt, A, Bm, Cm)]


@pytest.mark.parametrize("b,s,h,p,n,chunk", [(2, 32, 4, 16, 8, 16),
                                             (1, 64, 3, 32, 16, 64)])
def test_ssd_fn_grads_match_plain_autograd(b, s, h, p, n, chunk):
    ins = _ssd_inputs(b, s, h, p, n)
    dy = torch.randn(b, s, h, p, generator=torch.Generator().manual_seed(5))
    y = ops.ssd_diag(*ins, chunk=chunk)
    assert y.grad_fn is not None and "SSDDiagFn" in type(y.grad_fn).__name__
    got = torch.autograd.grad(y, ins, dy)
    want = torch.autograd.grad(ref.ssd_diag_ref(*ins, chunk=chunk), ins, dy)
    for g, w in zip(got, want, strict=True):
        torch.testing.assert_close(g, w, **TOL)


def test_ssd_plain_gradient_is_finite_where_decay_overflows():
    """Above the diagonal cum_i - cum_j grows with the chunk; masking it
    before the exp keeps exp's gradient there 0 and not inf * 0."""
    x, dt, A, Bm, Cm = _ssd_inputs(1, 64, 2, 8, 4)
    with torch.no_grad():
        dt.mul_(0).add_(4.0)
        A.copy_(torch.tensor([-1.0, -2.0]))     # cum reaches -512
    y = SSDDiagFn.apply(x, dt, A, Bm, Cm, 64)
    grads = torch.autograd.grad(y.sum(), [x, dt, A, Bm, Cm])
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_bf16_grads_within_one_rounding_of_plain_autograd():
    """In bfloat16 the backward sums delta from the recomputed p * dp, not
    from the rounded output: its gradients then differ from autograd through
    the plain version (exact float32 inside, one rounding out) by at most
    one bf16 ulp an element (and float32 noise, 1e-4 of the RMS, where the
    values are near zero). Taking delta from the bf16 output would move the
    first causal rows' dq and dk by some 5%."""
    gen = torch.Generator().manual_seed(8)
    b, hq, hkv, s, d = 2, 4, 1, 256, 256
    ins = [torch.randn(b, h, s, d, generator=gen).to(torch.bfloat16)
           .requires_grad_(True) for h in (hq, hkv, hkv)]
    dout = torch.randn(b, hq, s, d, generator=gen).to(torch.bfloat16)
    got = torch.autograd.grad(
        fa.FlashAttentionFn.apply(*ins, True, 0, 0, d ** -0.5), ins, dout)
    want = torch.autograd.grad(
        ref.flash_attention_ref(*ins, scale=d ** -0.5), ins, dout)
    for g, w in zip(got, want, strict=True):
        w = w.float()
        ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w).exponent - 8)
        noise = 1e-4 * w.pow(2).mean().sqrt()
        assert bool(((g.float() - w).abs() <= ulp + noise).all())
