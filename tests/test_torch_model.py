"""The port's dense model against the JAX package on identical weights.

Reduced configs in float32; JAX weights reach the port through
`repro_torch.models.convert`. Tolerance: 1e-4 absolute and relative on
float32 logits, because the two frameworks sum the matrix products of each
layer in different orders.
"""
import jax  # noqa: F401  (both packages in one process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import config_pair, numpy_tree, weights_pair
from repro.models import cpu_context
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import prefill as jax_prefill
from repro_torch.models import (
    decode_step, forward, init_cache, init_params, prefill,
)
from repro_torch.models.convert import cache_from_jax

ARCHS = ["gemma-2b", "gemma3-12b", "llama2-7b", "yi-6b"]
TOL = dict(rtol=1e-4, atol=1e-4)
CTX = cpu_context(remat=False)


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s), np.int32)


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(arch):
    jcfg, tcfg = config_pair(arch)
    jp, tp = weights_pair(jcfg, tcfg)
    toks = _tokens(0, 2, 32, jcfg.vocab_size)
    jl, _, _ = jax_forward(jp, {"tokens": jnp.asarray(toks)}, cfg=jcfg,
                           ctx=CTX, mode="train")
    tl, _ = forward(tp, {"tokens": torch.from_numpy(toks).long()}, cfg=tcfg,
                    mode="train")
    assert tl.shape == (2, 32, jcfg.vocab_size) and tl.dtype == torch.float32
    _close(tl, jl)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """Prefill fills the same cache; then decode steps with a (B,) position
    vector (rows at different positions, as in the engine) and with a
    scalar position give the JAX logits."""
    jcfg, tcfg = config_pair(arch)
    jp, tp = weights_pair(jcfg, tcfg)
    toks = _tokens(1, 2, 16, jcfg.vocab_size)
    jc = jax_init_cache(jcfg, 2, 64)
    tc = init_cache(tcfg, 2, 64, device="cpu")
    jlast, jc = jax_prefill(jp, {"tokens": jnp.asarray(toks)}, jc, cfg=jcfg,
                            ctx=CTX)
    tlast, tc = prefill(tp, {"tokens": torch.from_numpy(toks).long()}, tc,
                        cfg=tcfg)
    _close(tlast, jlast)
    for tl, jl in zip(tc, cache_from_jax(numpy_tree(jc), tcfg, "cpu"),
                      strict=True):
        _close(tl["k"], jl["k"].numpy())
        _close(tl["v"], jl["v"].numpy())

    nxt = _tokens(2, 2, 3, jcfg.vocab_size)
    for i, pos in enumerate(([16, 11], [17, 12], 18)):
        jpos = jnp.asarray(pos, jnp.int32)
        tpos = torch.tensor(pos, dtype=torch.int32)
        jl, jc = jax_decode_step(jp, jnp.asarray(nxt[:, i:i + 1]), jc, jpos,
                                 cfg=jcfg, ctx=CTX)
        tl, tc = decode_step(tp, torch.from_numpy(nxt[:, i:i + 1]).long(),
                             tc, tpos, cfg=tcfg)
        _close(tl, jl)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_from_a_converted_jax_cache(arch):
    jcfg, tcfg = config_pair(arch)
    jp, tp = weights_pair(jcfg, tcfg)
    toks = _tokens(3, 2, 17, jcfg.vocab_size)
    _, jc = jax_prefill(jp, {"tokens": jnp.asarray(toks[:, :16])},
                        jax_init_cache(jcfg, 2, 32), cfg=jcfg, ctx=CTX)
    tc = cache_from_jax(numpy_tree(jc), tcfg, "cpu")
    pos = jnp.asarray([16, 16], jnp.int32)
    jl, _ = jax_decode_step(jp, jnp.asarray(toks[:, 16:]), jc, pos, cfg=jcfg,
                            ctx=CTX)
    tl, _ = decode_step(tp, torch.from_numpy(toks[:, 16:]).long(), tc,
                        torch.tensor([16, 16], dtype=torch.int32), cfg=tcfg)
    _close(tl, jl)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward(arch):
    """Prefill of S-1 tokens then one decode step == the full forward's
    last two positions (the port's own consistency, as the JAX package
    checks its own)."""
    _, tcfg = config_pair(arch)
    tp = init_params(tcfg, seed=3, device="cpu")
    toks = torch.from_numpy(_tokens(4, 2, 32, tcfg.vocab_size)).long()
    full, _ = forward(tp, {"tokens": toks}, cfg=tcfg, mode="train")
    cache = init_cache(tcfg, 2, 64, device="cpu")
    last, cache = prefill(tp, {"tokens": toks[:, :31]}, cache, cfg=tcfg)
    torch.testing.assert_close(last, full[:, 30], **TOL)
    logits, _ = decode_step(tp, toks[:, 31:], cache, 31, cfg=tcfg)
    torch.testing.assert_close(logits, full[:, 31], **TOL)


def test_rolling_window_cache_matches_full_and_jax():
    """gemma3-12b's local layers keep a rolling cache of 64 slots: decoding
    past the window through it == full attention with the window mask, and
    == the JAX decode."""
    jcfg, tcfg = config_pair("gemma3-12b")
    assert tcfg.sliding_window == 64 and tcfg.n_layers == 6
    jp, tp = weights_pair(jcfg, tcfg)
    toks = _tokens(5, 1, 72, jcfg.vocab_size)
    tt = torch.from_numpy(toks).long()
    full, _ = forward(tp, {"tokens": tt}, cfg=tcfg, mode="train")
    tc = init_cache(tcfg, 1, 256, device="cpu")
    assert tc[0]["k"].shape[1] == 64 and tc[5]["k"].shape[1] == 256
    jc = jax_init_cache(jcfg, 1, 256)
    last, tc = prefill(tp, {"tokens": tt[:, :64]}, tc, cfg=tcfg)
    _, jc = jax_prefill(jp, {"tokens": jnp.asarray(toks[:, :64])}, jc,
                        cfg=jcfg, ctx=CTX)
    torch.testing.assert_close(last, full[:, 63], **TOL)
    for t in range(64, 72):
        logits, tc = decode_step(tp, tt[:, t:t + 1], tc, t, cfg=tcfg)
        jl, jc = jax_decode_step(jp, jnp.asarray(toks[:, t:t + 1]), jc,
                                 jnp.int32(t), cfg=jcfg, ctx=CTX)
        torch.testing.assert_close(logits, full[:, t], **TOL)
        _close(logits, jl)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_matches_jax_layout_and_scales(arch):
    """`init_params` draws its own bits but has the JAX tree's layout,
    dtypes and scales."""
    jcfg, tcfg = config_pair(arch)
    _, ref = weights_pair(jcfg, tcfg)
    got = init_params(tcfg, seed=0, device="cpu")
    flat_ref = _flatten(ref)
    flat_got = _flatten(got)
    assert flat_ref.keys() == flat_got.keys()
    for name, r in flat_ref.items():
        g = flat_got[name]
        assert g.shape == r.shape and g.dtype == r.dtype, name
        if r.numel() > 1000:
            assert abs(g.std().item() / r.std().item() - 1) < 0.1, name
        else:
            assert torch.equal(g, r), name    # norm scales start at zero


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}"))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}/{i}"))
    else:
        out[prefix] = tree
    return out


def test_entry_points_default_to_cuda():
    """Without a device argument the port runs on the card, or raises."""
    _, tcfg = config_pair("gemma-2b")
    if torch.cuda.is_available():
        assert init_cache(tcfg, 1, 8)[0]["k"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_params(tcfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_cache(tcfg, 1, 8)
