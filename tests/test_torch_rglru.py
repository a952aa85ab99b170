"""The port's RG-LRU hybrid family (recurrentgemma-2b) against the JAX
package on identical weights.

Reduced recurrentgemma-2b in float32 (a (rec, rec, attn(window 64))
superblock); JAX weights and caches reach the port through
`repro_torch.models.convert`. Tolerances: 2e-5 absolute and relative for
one function or layer, 1e-4 for whole-model logits (the frameworks sum each
layer's products in different orders), greedy tokens exact for engines.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import config_pair, numpy_tree, weights_pair
from repro.configs import get_config as jax_get_config
from repro.models import cpu_context
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.models import rglru as JRG
from repro.serving import ServingEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.models import (
    decode_step, forward, init_cache, init_params, prefill,
)
from repro_torch.models import rglru as RG
from repro_torch.models import transformer as T
from repro_torch.models.convert import cache_from_jax
from repro_torch.serving import ServingEngine

ARCH = "recurrentgemma-2b"
FN_TOL = dict(rtol=2e-5, atol=2e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
CTX = cpu_context(remat=False)


def _normal(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s), np.int32)


def _close(t, j, tol=FN_TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **tol)


@pytest.fixture(scope="module")
def layer_pair():
    """The first rec layer's weights in both packages, with gates that are
    not the zeros of init (so that r and i vary by channel)."""
    jcfg, tcfg = config_pair(ARCH)
    jp, tp = weights_pair(jcfg, tcfg)
    jmix = dict(jax.tree.map(lambda a: a[0], jp["stack"]["sb"][0]["mix"]))
    dr = jmix["w_a"].shape[0]
    for i, key in enumerate(("w_a", "b_a", "w_x", "b_x")):
        jmix[key] = jnp.asarray(_normal(40 + i, dr, scale=0.5))
    tmix = dict(tp["layers"][0]["mix"])
    for key in ("w_a", "b_a", "w_x", "b_x"):
        tmix[key] = torch.from_numpy(np.array(jmix[key]))
    return jcfg, tcfg, jmix, tmix


# ---------------------------------------------------------------------------
# the layer's pieces
# ---------------------------------------------------------------------------


def test_gates_match_jax(layer_pair):
    _, tcfg, jmix, tmix = layer_pair
    u = _normal(0, 2, 7, tcfg.rglru.d_rnn, scale=3.0)
    ja, jg = JRG._gates(jmix, jnp.asarray(u))
    ta, tg = RG._gates(tmix, torch.from_numpy(u))
    assert ta.dtype == tg.dtype == torch.float32
    _close(ta, ja)
    _close(tg, jg)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s", [1, 2, 9])
def test_conv_causal_matches_jax(layer_pair, with_state, s):
    """The conv and its state: the last d_conv - 1 rows of the padded input
    (the zero pad, or the given state, where S < d_conv - 1)."""
    _, tcfg, jmix, tmix = layer_pair
    dr, k = tcfg.rglru.d_rnn, tcfg.rglru.d_conv
    u = _normal(1, 2, s, dr)
    state = _normal(2, 2, k - 1, dr) if with_state else None
    jout, jstate = JRG._conv_causal(
        jnp.asarray(u), jmix["conv"],
        None if state is None else jnp.asarray(state))
    tout, tstate = RG._conv_causal(
        torch.from_numpy(u), tmix["conv"],
        None if state is None else torch.from_numpy(state))
    assert tstate.shape == (2, k - 1, dr)
    _close(tout, jout)
    _close(tstate, jstate)


def _scan_loop(a, b):
    h = torch.zeros_like(b[:, 0])
    out = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out.append(h)
    return torch.stack(out, dim=1)


@pytest.mark.parametrize("s", [1, 5, 16, 64])
def test_linear_scan_matches_associative_scan_and_a_loop(s):
    """The doubling scan against `jax.lax.associative_scan` of the same
    pair operator (what the JAX layer runs) and a sequential loop."""
    a = np.random.default_rng(s).uniform(0.5, 1.0, (2, s, 24)).astype(
        np.float32)
    b = _normal(s + 1, 2, s, 24)
    got = RG.linear_scan(torch.from_numpy(a), torch.from_numpy(b))

    def combine(c1, c2):
        return c1[0] * c2[0], c2[0] * c1[1] + c2[1]

    _, want = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                 jnp.asarray(b)), axis=1)
    assert got.shape == (2, s, 24)
    _close(got, want)
    _close(got, _scan_loop(torch.from_numpy(a), torch.from_numpy(b)))


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_rglru_layer_matches_jax(layer_pair, mode):
    """Train and prefill (the prefill state, h of the last row and the conv
    tail, in place in the port's cache)."""
    jcfg, tcfg, jmix, tmix = layer_pair
    x = _normal(3, 2, 13, tcfg.d_model)
    jout, jc = JRG.rglru_layer(jmix, jnp.asarray(x), cfg=jcfg, ctx=CTX,
                               mode=mode)
    cache = RG.init_rglru_cache(tcfg, 2, device="cpu") \
        if mode == "prefill" else None
    tout, tc = RG.rglru_layer(tmix, torch.from_numpy(x), cfg=tcfg, mode=mode,
                              cache=cache)
    assert tout.shape == x.shape
    _close(tout, jout)
    if mode == "train":
        assert jc is None and tc is None
        return
    assert tc is cache
    assert tc["h"].dtype == torch.float32
    for key in ("h", "conv"):
        _close(tc[key], jc[key])


def test_rglru_layer_decode_matches_jax(layer_pair):
    """Prefill, then O(1) decode steps from the prefill state."""
    jcfg, tcfg, jmix, tmix = layer_pair
    x = _normal(4, 2, 6, tcfg.d_model)
    _, jc = JRG.rglru_layer(jmix, jnp.asarray(x), cfg=jcfg, ctx=CTX,
                            mode="prefill")
    tc = RG.init_rglru_cache(tcfg, 2, device="cpu")
    RG.rglru_layer(tmix, torch.from_numpy(x), cfg=tcfg, mode="prefill",
                   cache=tc)
    for i in range(3):
        xt = _normal(10 + i, 2, 1, tcfg.d_model)
        jout, jc = JRG.rglru_layer(jmix, jnp.asarray(xt), cfg=jcfg, ctx=CTX,
                                   mode="decode", cache=jc)
        tout, tc = RG.rglru_layer(tmix, torch.from_numpy(xt), cfg=tcfg,
                                  mode="decode", cache=tc)
        _close(tout, jout)
        for key in ("h", "conv"):
            _close(tc[key], jc[key])


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_full_width_program_and_cache():
    """recurrentgemma-2b: (rec, rec, attn(2048)) x 8 + (rec, rec), 26
    layers of which 8 attend (10 q-heads on 1 kv-head, D 256); its config
    is the JAX package's."""
    cfg = get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_get_config(ARCH))
    prog = T.block_program(cfg)
    assert prog.superblock == (T.LayerSpec("rec"), T.LayerSpec("rec"),
                               T.LayerSpec("attn", window=2048))
    assert prog.n_superblocks == 8
    assert prog.tail == (T.LayerSpec("rec"), T.LayerSpec("rec"))
    kinds = [s.kind for s in prog.layers()]
    assert len(kinds) == 26 and kinds.count("attn") == 8
    assert cfg.n_heads // cfg.n_kv_heads == 10 and cfg.resolved_head_dim == 256
    cache = init_cache(cfg, 2, 256, device="meta")
    assert cache[0]["h"].shape == (2, 2560)
    assert cache[0]["h"].dtype == torch.float32
    assert cache[0]["conv"].shape == (2, 3, 2560)
    assert cache[0]["conv"].dtype == torch.bfloat16
    assert cache[2]["k"].shape == (2, 256, 1, 256)


def test_init_params_matches_jax_layout():
    """`init_params` draws its own bits but has the JAX tree's layout and
    dtypes: in a bf16 model the gates and lam stay float32, and lam puts
    a = exp(-8 softplus(lam)) in [0.9, 0.999]."""
    jcfg = jax_get_config(ARCH).reduced()
    tcfg = get_config(ARCH).reduced()
    ref = jax.tree.map(np.asarray, jax_init_params(jax.random.key(0), jcfg))
    got = init_params(tcfg, seed=0, device="cpu")
    assert len(got["layers"]) == tcfg.n_layers
    jrec = jax.tree.map(lambda a: a[0], ref["stack"]["sb"][0])
    trec = got["layers"][0]
    assert trec.keys() == jrec.keys() == {"norm1", "mix", "norm2", "mlp"}
    assert trec["mix"].keys() == jrec["mix"].keys()
    for key, leaf in trec["mix"].items():
        want = jrec["mix"][key]
        assert tuple(leaf.shape) == want.shape, key
        assert str(leaf.dtype).split(".")[-1] == want.dtype.name, key
    for key in ("w_a", "b_a", "w_x", "b_x", "lam"):
        assert trec["mix"][key].dtype == torch.float32
    a = torch.exp(-8.0 * torch.nn.functional.softplus(trec["mix"]["lam"]))
    assert bool(((a > 0.9 - 1e-6) & (a < 0.999 + 1e-6)).all())


def test_convert_keeps_the_float32_leaves_of_a_bf16_tree():
    """A bf16 JAX tree carried over by `convert`: the gates, lam, the norm
    scales and the cache's h stay float32, the rest bf16."""
    from repro_torch.models.convert import params_from_jax
    cfg = get_config(ARCH).reduced()
    jcfg = jax_get_config(ARCH).reduced()
    tp = params_from_jax(numpy_tree(jax_init_params(jax.random.key(1), jcfg)),
                         cfg, device="cpu")
    mix = tp["layers"][0]["mix"]
    for key in ("w_a", "b_a", "w_x", "b_x", "lam"):
        assert mix[key].dtype == torch.float32, key
    for key in ("w_gate_in", "w_rec_in", "conv", "out_proj"):
        assert mix[key].dtype == torch.bfloat16, key
    assert tp["layers"][0]["norm1"]["scale"].dtype == torch.float32
    cache = cache_from_jax(numpy_tree(jax_init_cache(jcfg, 2, 64)), cfg,
                           "cpu")
    assert cache[0]["h"].dtype == torch.float32
    assert cache[0]["conv"].dtype == cache[2]["k"].dtype == torch.bfloat16


def test_forward_logits_match_jax():
    jcfg, tcfg = config_pair(ARCH, n_layers=5)
    jp, tp = weights_pair(jcfg, tcfg)
    toks = _tokens(0, 2, 40, jcfg.vocab_size)
    jl, _, _ = jax_forward(jp, {"tokens": jnp.asarray(toks)}, cfg=jcfg,
                           ctx=CTX, mode="train")
    tl, _ = forward(tp, {"tokens": torch.from_numpy(toks).long()}, cfg=tcfg,
                    mode="train")
    assert tl.shape == (2, 40, jcfg.vocab_size) and tl.dtype == torch.float32
    _close(tl, jl, TOL)


def test_prefill_and_decode_match_jax():
    """Prefill fills the same rec states and K/V; decode steps then give
    the JAX logits and states, with (B,) and scalar positions; and a decode
    step from the JAX cache carried over by `cache_from_jax`."""
    jcfg, tcfg = config_pair(ARCH)
    jp, tp = weights_pair(jcfg, tcfg)
    toks = _tokens(1, 2, 24, jcfg.vocab_size)
    jc = jax_init_cache(jcfg, 2, 64)
    tc = init_cache(tcfg, 2, 64, device="cpu")
    jlast, jc = jax_prefill(jp, {"tokens": jnp.asarray(toks[:, :20])}, jc,
                            cfg=jcfg, ctx=CTX)
    tlast, tc = prefill(tp, {"tokens": torch.from_numpy(toks[:, :20]).long()},
                        tc, cfg=tcfg)
    _close(tlast, jlast, TOL)
    converted = cache_from_jax(numpy_tree(jc), tcfg, "cpu")
    for tl, jl in zip(tc, converted, strict=True):
        assert tl.keys() == jl.keys()
        for key in tl:
            assert tl[key].dtype == jl[key].dtype, key
            _close(tl[key], jl[key].numpy(), TOL)
    for i, t in enumerate(range(20, 24)):
        pos = t if i % 2 else [t, t]
        jl, jc = jax_decode_step(jp, jnp.asarray(toks[:, t:t + 1]), jc,
                                 jnp.asarray(pos, jnp.int32), cfg=jcfg,
                                 ctx=CTX)
        tok = torch.from_numpy(toks[:, t:t + 1]).long()
        tl, tc = decode_step(tp, tok, tc, torch.tensor(pos, dtype=torch.int32),
                             cfg=tcfg)
        _close(tl, jl, TOL)
        if i == 0:
            cl, _ = decode_step(tp, tok, converted,
                                torch.tensor(pos, dtype=torch.int32),
                                cfg=tcfg)
            _close(cl, jl, TOL)


def test_prefill_decode_matches_forward():
    """Prefill of S-1 tokens then one decode step == the full forward's
    last two positions (the O(1) step equals the scan)."""
    _, tcfg = config_pair(ARCH)
    tp = init_params(tcfg, seed=3, device="cpu")
    toks = torch.from_numpy(_tokens(4, 2, 32, tcfg.vocab_size)).long()
    full, _ = forward(tp, {"tokens": toks}, cfg=tcfg, mode="train")
    cache = init_cache(tcfg, 2, 64, device="cpu")
    last, cache = prefill(tp, {"tokens": toks[:, :31]}, cache, cfg=tcfg)
    torch.testing.assert_close(last, full[:, 30], **TOL)
    logits, _ = decode_step(tp, toks[:, 31:], cache, 31, cfg=tcfg)
    torch.testing.assert_close(logits, full[:, 31], **TOL)


def test_causality():
    """Changing tokens from position 16 on leaves the logits before it."""
    _, tcfg = config_pair(ARCH)
    tp = init_params(tcfg, seed=0, device="cpu")
    toks = torch.from_numpy(_tokens(5, 1, 32, tcfg.vocab_size)).long()
    l1, _ = forward(tp, {"tokens": toks}, cfg=tcfg, mode="train")
    toks2 = toks.clone()
    toks2[0, 16:] = (toks2[0, 16:] + 3) % tcfg.vocab_size
    l2, _ = forward(tp, {"tokens": toks2}, cfg=tcfg, mode="train")
    torch.testing.assert_close(l1[:, :16], l2[:, :16], rtol=1e-5, atol=1e-5)
    assert not torch.allclose(l1[:, 16:], l2[:, 16:])


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _engines(max_batch=3, max_seq=64, **kw):
    jcfg, tcfg = config_pair(ARCH, n_layers=3, d_model=128, vocab_size=512)
    jp, tp = weights_pair(jcfg, tcfg)
    return (JaxEngine(jcfg, jp, max_batch=max_batch, max_seq=max_seq, **kw),
            ServingEngine(tcfg, tp, max_batch=max_batch, max_seq=max_seq,
                          device="cpu", **kw))


def test_engine_greedy_tokens_match_jax_engine():
    """Prompts of 5, 7, 11, 13 and 19 tokens (none a power of two): the
    pad tokens of each prefill bucket run through the recurrence into h and
    the conv state, in the JAX engine and in the port alike."""
    je, te = _engines()
    for i, n in enumerate((5, 7, 11, 13, 19)):
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


def test_engine_decodes_past_its_window_as_jax():
    """The attention layer keeps a rolling cache of its 64-slot window: a
    70-token prompt is prefilled into the last 64 slots and every request
    decodes past the window, with the JAX engine's tokens."""
    je, te = _engines(max_seq=128)
    assert te.cache[2]["k"].shape[1] == 64
    for i, n in enumerate((45, 60, 70)):
        p = [(5 * i + 7 * j) % 512 for j in range(n)]
        je.submit(p, max_new_tokens=24)
        te.submit(p, max_new_tokens=24)
    jd = sorted(je.run_until_idle(), key=lambda r: r.rid)
    td = sorted(te.run_until_idle(), key=lambda r: r.rid)
    assert [r.generated for r in td] == [r.generated for r in jd]
    assert all(len(r.prompt) + len(r.generated) > 64 for r in td)


def test_paged_engine_evict_resubmit_keeps_the_rec_state():
    """A paged hybrid engine pages the attention K/V and carries h and the
    conv state whole in the `KVSnapshot`; it keeps no prefix index (0
    hits, as in JAX). Evict mid-decode and resubmit: the tokens of an
    uninterrupted run and of the JAX engine doing the same, one prefill a
    request."""
    je, te = _engines(max_batch=2, paged=True, kv_block_tokens=16)
    assert not te.kv.supports_prefix and te.kv.prefix is None
    axes = dict(zip(te.kv._leaf_names(), te.kv._seq_axis, strict=True))
    assert axes[(0, "h")] is None and axes[(0, "conv")] is None
    assert axes[(2, "k")] == axes[(2, "v")] == 1
    ref_eng = _engines(max_batch=2)[1]
    head = [(5 * j + 2) % 512 for j in range(32)]
    prompts = [head + [9, 8, 7], head + [1, 2, 3]]
    for p in prompts:
        ref_eng.submit(p, max_new_tokens=10)
    ref = [r.generated for r in sorted(ref_eng.run_until_idle(),
                                       key=lambda r: r.rid)]
    outs = []
    for eng in (je, te):
        reqs = [eng.submit(prompts[0], max_new_tokens=10)]
        for _ in range(4):
            eng.step()
        victim = eng.evict(reqs[0].slot)
        assert victim is reqs[0] and victim.kv is not None
        reqs.append(eng.submit(prompts[1], max_new_tokens=10))
        eng.step()
        eng.resubmit(victim)
        eng.run_until_idle()
        assert eng.n_prefills == 2 and eng.n_prefix_hits == 0
        assert eng.kv.free_blocks == eng.kv.n_blocks
        outs.append([r.generated for r in reqs])
    assert outs[1] == outs[0] == ref
