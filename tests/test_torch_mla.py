"""The port's MLA family (minicpm3-4b) against the JAX package on identical
weights.

Reduced minicpm3-4b in float32 (qk_nope 32 + qk_rope 16: prefill attends
at head_dim 48); JAX weights and caches reach the port through
`repro_torch.models.convert`. Tolerances: 2e-5 absolute and relative for
one `mla_layer` call, 1e-4 for whole-model logits (the frameworks sum each
layer's products in different orders), greedy tokens exact for engines.
"""
import jax  # noqa: F401  (both packages in one process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import config_pair, numpy_tree, weights_pair
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models import cpu_context
from repro.models import decode_step as jax_decode_step
from repro.models import init_cache as jax_init_cache
from repro.models import layers as JL
from repro.models import prefill as jax_prefill
from repro.serving import ServingEngine as JaxEngine
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import decode_step, init_cache, prefill
from repro_torch.models import layers as L
from repro_torch.models.convert import cache_from_jax
from repro_torch.serving import ServingEngine
from repro_torch.serving.kvcache import PagedKVCache

FN_TOL = dict(rtol=2e-5, atol=2e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
CTX = cpu_context(remat=False)
ARCH = "minicpm3-4b"


def _close(t, j, tol=FN_TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **tol)


@pytest.fixture(scope="module")
def layer_pair():
    """The first MLA layer's weights in both packages."""
    jcfg, tcfg = config_pair(ARCH)
    jp, tp = weights_pair(jcfg, tcfg)
    jmix = jax.tree.map(lambda a: a[0], jp["stack"]["sb"][0]["mix"])
    return jcfg, tcfg, jmix, tp["layers"][0]["mix"]


def _x(seed, b, s, d):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        np.float32)


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_mla_layer_without_cache_matches_jax(layer_pair, mode):
    jcfg, tcfg, jmix, tmix = layer_pair
    x = _x(0, 2, 24, tcfg.d_model)
    jout, jc = JL.mla_layer(jmix, jnp.asarray(x), cfg=jcfg, ctx=CTX,
                            mode=mode)
    tout, tc = L.mla_layer(tmix, torch.from_numpy(x), cfg=tcfg, mode=mode)
    assert jc is None and tc is None
    assert tout.shape == x.shape
    _close(tout, jout)


def test_mla_prefill_with_cache_matches_jax(layer_pair):
    """Prefill writes the latent slots [0, S) and attends over the prompt."""
    jcfg, tcfg, jmix, tmix = layer_pair
    x = _x(1, 2, 16, tcfg.d_model)
    jout, jc = JL.mla_layer(jmix, jnp.asarray(x), cfg=jcfg, ctx=CTX,
                            mode="prefill",
                            cache=JL.init_mla_cache(jcfg, 2, 40))
    tcache = L.init_mla_cache(tcfg, 2, 40, device="cpu")
    tout, tc = L.mla_layer(tmix, torch.from_numpy(x), cfg=tcfg,
                           mode="prefill", cache=tcache)
    assert tc is tcache                       # written in place
    assert tc["ckv"].shape == (2, 40, tcfg.mla.kv_lora_rank)
    assert tc["krope"].shape == (2, 40, tcfg.mla.qk_rope_head_dim)
    _close(tout, jout)
    for key in ("ckv", "krope"):
        _close(tc[key], jc[key])
        assert not tc[key][:, 16:].any()


def test_mla_decode_with_vector_pos_matches_jax(layer_pair):
    """The weight-absorbed latent decode, rows at different positions."""
    jcfg, tcfg, jmix, tmix = layer_pair
    x = _x(2, 2, 16, tcfg.d_model)
    _, jc = JL.mla_layer(jmix, jnp.asarray(x), cfg=jcfg, ctx=CTX,
                         mode="prefill", cache=JL.init_mla_cache(jcfg, 2, 40))
    tc = L.init_mla_cache(tcfg, 2, 40, device="cpu")
    L.mla_layer(tmix, torch.from_numpy(x), cfg=tcfg, mode="prefill", cache=tc)
    for i, pos in enumerate(([16, 9], [17, 10], [18, 30])):
        xt = _x(10 + i, 2, 1, tcfg.d_model)
        jout, jc = JL.mla_layer(jmix, jnp.asarray(xt), cfg=jcfg, ctx=CTX,
                                mode="decode", cache=jc,
                                pos=jnp.asarray(pos, jnp.int32))
        tout, tc = L.mla_layer(tmix, torch.from_numpy(xt), cfg=tcfg,
                               mode="decode", cache=tc,
                               pos=torch.tensor(pos, dtype=torch.int32))
        _close(tout, jout)
        for key in ("ckv", "krope"):
            _close(tc[key], jc[key])


def test_mla_prefill_and_decode_match_jax():
    """The whole model: prefill, then decode with (B,) and scalar positions;
    and decode from a JAX latent cache carried over by `cache_from_jax`."""
    jcfg, tcfg = config_pair(ARCH)
    jp, tp = weights_pair(jcfg, tcfg)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 16),
                                             np.int32)
    jc = jax_init_cache(jcfg, 2, 64)
    tc = init_cache(tcfg, 2, 64, device="cpu")
    assert all(c.keys() == {"ckv", "krope"} for c in tc)
    jlast, jc = jax_prefill(jp, {"tokens": jnp.asarray(toks)}, jc, cfg=jcfg,
                            ctx=CTX)
    tlast, tc = prefill(tp, {"tokens": torch.from_numpy(toks).long()}, tc,
                        cfg=tcfg)
    _close(tlast, jlast, TOL)
    converted = cache_from_jax(numpy_tree(jc), tcfg, "cpu")
    for tl, jl in zip(tc, converted, strict=True):
        for key in ("ckv", "krope"):
            _close(tl[key], jl[key].numpy(), TOL)
    nxt = np.random.default_rng(4).integers(0, jcfg.vocab_size, (2, 3),
                                            np.int32)
    for i, pos in enumerate(([16, 11], [17, 12], 18)):
        jl, jc = jax_decode_step(jp, jnp.asarray(nxt[:, i:i + 1]), jc,
                                 jnp.asarray(pos, jnp.int32), cfg=jcfg,
                                 ctx=CTX)
        tok = torch.from_numpy(nxt[:, i:i + 1]).long()
        tl, tc = decode_step(tp, tok, tc, torch.tensor(pos, dtype=torch.int32),
                             cfg=tcfg)
        _close(tl, jl, TOL)
        if i == 0:     # the same step from the converted JAX cache
            cl, _ = decode_step(tp, tok, converted,
                                torch.tensor(pos, dtype=torch.int32),
                                cfg=tcfg)
            _close(cl, jl, TOL)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("d", [48, 96])
def test_flash_plain_at_mla_head_dims_matches_pallas(d, dtype, tol):
    """MLA prefill attends at head_dim qk_nope + qk_rope: 48 reduced, 96 at
    full width. The plain version against the JAX oracle and the Pallas
    kernel in interpret mode, with GQA and a window."""
    rng = np.random.default_rng(d)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((1, 4, 64, d), (1, 2, 64, d), (1, 2, 64, d)))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    qj, kj, vj = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    scale = d ** -0.5
    for window in (0, 16):
        out = flash_attention(*(torch.from_numpy(a).to(dtype)
                                for a in (q, k, v)), window=window,
                              scale=scale)
        ref = jref.flash_attention_ref(qj, kj, vj, causal=True,
                                       window=window, scale=scale)
        pallas = pallas_flash(qj, kj, vj, causal=True, window=window,
                              scale=scale, block_q=32, block_k=32,
                              interpret=True)
        for want in (ref, pallas):
            np.testing.assert_allclose(out.float().numpy(),
                                       np.asarray(want, np.float32),
                                       rtol=tol, atol=tol)


def test_paged_cache_pools_the_latent_leaves():
    """The paged cache's probe finds the latent leaves' sequence axis (1)
    and keeps the prefix index, as the JAX package's does."""
    _, tcfg = config_pair(ARCH)
    kv = PagedKVCache(tcfg, n_blocks=8, block_tokens=16, max_seq=64,
                      device="cpu")
    assert kv.supports_prefix and kv.prefix is not None
    assert kv._seq_axis == [1] * (2 * tcfg.n_layers)
    m = tcfg.mla
    ranks = [m.kv_lora_rank, m.qk_rope_head_dim] * tcfg.n_layers
    # (n_blocks, block_tokens, batch 1, rank), as attention pools keep
    # the batch axis of the single-slot cache
    assert [tuple(p.shape) for p in kv._pools] == [(8, 16, 1, r)
                                                   for r in ranks]


def _engine_pair(**kw):
    jcfg, tcfg = config_pair(ARCH, n_layers=2, d_model=128, vocab_size=512)
    jp, tp = weights_pair(jcfg, tcfg)
    kw = dict(max_batch=2, max_seq=128, paged=True, kv_block_tokens=16, **kw)
    return JaxEngine(jcfg, jp, ctx=CTX, **kw), \
        ServingEngine(tcfg, tp, device="cpu", **kw)


def test_paged_engine_prefix_hit_on_latent_pages_matches_jax():
    """A prompt opening with an earlier prompt's two full blocks attaches
    their latent pages and decodes only its suffix: the same tokens and
    counters as the JAX engine."""
    head = [(5 * j + 2) % 512 for j in range(32)]
    prompts = [head + [9, 8, 7], head + [1, 2, 3, 4], [4, 5, 6]]
    out = []
    for eng in _engine_pair():
        for p in prompts:
            eng.submit(p, max_new_tokens=6)
            eng.run_until_idle()
        out.append(([r.generated for r in eng.completed], eng.stats()))
        assert eng.n_prefix_hits == 1 and eng.prefix_tokens_reused == 32
    assert out[0] == out[1]


def test_paged_engine_evict_resume_on_latent_pages_matches_jax():
    """A request evicted mid-decode keeps its latent pages and resumes
    with no second prefill, with the JAX engine's tokens."""
    out = []
    for eng in _engine_pair():
        first = eng.submit(list(range(3, 40)), max_new_tokens=10)
        for _ in range(3):
            eng.step()
        victim = eng.evict(first.slot)
        assert victim is first and first.kv is not None
        second = eng.submit([7, 8, 9, 10], max_new_tokens=10)
        eng.step()
        eng.resubmit(victim)
        eng.run_until_idle()
        assert eng.n_prefills == 2
        out.append((first.generated, second.generated))
    assert out[0] == out[1]
