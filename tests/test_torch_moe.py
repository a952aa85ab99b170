"""The port's MoE family against the JAX package on identical weights.

Reduced deepseek-moe-16b (a dense-MLP head layer, then MoE layers with a
shared expert) and mixtral-8x7b (windowed attention, MoE in every layer)
in float32; JAX weights reach the port through
`repro_torch.models.convert`. Tolerances: 2e-5 relative for one layer's
function (`moe_layer`, `moe_layer_capacity`, the aux loss), and 2e-5 of
the output's RMS absolute (the experts' outputs reach a few hundred at
these widths, where a float32 ulp is ~3e-5); 1e-4 for whole-model logits
(as `tests/test_torch_model.py`: the frameworks sum each layer's products
in different orders); greedy tokens exact for engines.
"""
import dataclasses

import jax  # noqa: F401  (both packages in one process)
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
from repro.models import prefill as jax_prefill
from repro.models import moe as JMOE
from repro.models.transformer import block_program as jax_block_program
from repro.serving import ServingEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.models import (
    decode_step, forward, init_cache, init_params, prefill,
)
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.models.convert import cache_from_jax
from repro_torch.models.model import embed_tokens
from repro_torch.serving import ServingEngine

MOE_ARCHS = ["deepseek-moe-16b", "mixtral-8x7b"]
ALL_ARCHS = MOE_ARCHS + ["minicpm3-4b"]
FN_TOL = dict(rtol=2e-5, atol=2e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
CTX = cpu_context(remat=False)


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s), np.int32)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **tol)


def _close_fn(t, j):
    """One layer's output at FN_TOL, the absolute part scaled by the
    output's RMS."""
    j = np.asarray(j)
    rms = max(1.0, float(np.sqrt(np.mean(np.square(j)))))
    np.testing.assert_allclose(t.detach().numpy(), j, rtol=FN_TOL["rtol"],
                               atol=FN_TOL["atol"] * rms)


def _moe_pair(arch):
    """The first MoE layer's weights in both packages, and an input."""
    jcfg, tcfg = config_pair(arch)
    jp, tp = weights_pair(jcfg, tcfg)
    jmoe = jax.tree.map(lambda a: a[0], jp["stack"]["sb"][0]["moe"])
    layer = len(T.block_program(tcfg).head)
    x = np.random.default_rng(7).standard_normal(
        (2, 16, tcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jmoe, tp["layers"][layer]["moe"], x


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_layer_matches_jax(arch):
    jcfg, tcfg, jmoe, tmoe, x = _moe_pair(arch)
    jout, jaux = JMOE.moe_layer(jmoe, jnp.asarray(x), cfg=jcfg, ctx=CTX)
    tout, taux = MOE.moe_layer(tmoe, torch.from_numpy(x), cfg=tcfg)
    assert tout.shape == x.shape and tout.dtype == torch.float32
    _close_fn(tout, jout)
    _close_fn(taux["moe_aux_loss"], jaux["moe_aux_loss"])


@pytest.mark.parametrize("cf", [1.0, 8.0])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_layer_capacity_matches_jax(arch, cf):
    """At capacity_factor 1.0 some (token, expert) pairs overflow and are
    dropped, the same ones as in the JAX package (a stable sort); at 8.0
    nothing is dropped and the layer equals the dense dispatch."""
    jcfg, tcfg, jmoe, tmoe, x = _moe_pair(arch)
    jout, jaux = JMOE.moe_layer_capacity(jmoe, jnp.asarray(x), cfg=jcfg,
                                         ctx=CTX, capacity_factor=cf)
    tx = torch.from_numpy(x)
    tout, taux = MOE.moe_layer_capacity(tmoe, tx, cfg=tcfg,
                                        capacity_factor=cf)
    _close_fn(tout, jout)
    _close_fn(taux["moe_aux_loss"], jaux["moe_aux_loss"])
    dense, _ = MOE.moe_layer(tmoe, tx, cfg=tcfg)
    dropped = not torch.allclose(tout, dense, rtol=2e-5,
                                 atol=2e-5 * dense.pow(2).mean().sqrt().item())
    assert dropped == (cf == 1.0)


def test_moe_capacity_drops_by_stable_order():
    """Ties in the expert sort keep token order: with every token routed
    to the same experts, the first `cap` tokens of a row are kept."""
    _, tcfg = config_pair("mixtral-8x7b")
    tcfg = dataclasses.replace(tcfg, n_shared_experts=0)
    p = MOE.init_moe(torch.Generator().manual_seed(0), tcfg, "cpu")
    p["router"] = torch.zeros_like(p["router"])
    p["router"][0, :2] = 1.0              # experts 0 and 1 win for x[0] > 0
    x = torch.rand(1, 8, tcfg.d_model) + 0.5
    out, _ = MOE.moe_layer_capacity(p, x, cfg=tcfg, capacity_factor=1.0)
    cap = 4                                   # ceil(2 * 8 / 4 * 1.0)
    dense, _ = MOE.moe_layer(p, x, cfg=tcfg)
    torch.testing.assert_close(out[0, :cap], dense[0, :cap], **FN_TOL)
    assert torch.equal(out[0, cap:], torch.zeros_like(out[0, cap:]))


def test_moe_dispatch_rejects_unknown_names():
    with pytest.raises(ValueError, match="moe_dispatch"):
        MOE.moe_fn("all_to_all")
    # the expert-parallel all-to-all is a dispatch of its own (without a
    # mesh it is capacity dispatch, as in the JAX package)
    assert MOE.moe_fn("ep_a2a") is MOE.moe_layer_ep_a2a


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_block_program_matches_jax(arch, reduced):
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    jprog, tprog = jax_block_program(jcfg), T.block_program(tcfg)

    def specs(seq):
        return [(s.kind, s.window, s.moe) for s in seq]

    assert not any(s.cross for s in jprog.superblock)
    assert specs(tprog.head) == specs(jprog.head)
    assert specs(tprog.superblock) == specs(jprog.superblock)
    assert specs(tprog.tail) == specs(jprog.tail)
    assert tprog.n_superblocks == jprog.n_superblocks
    assert tprog.n_layers == jprog.n_layers == tcfg.n_layers


def test_block_programs_of_the_ported_families():
    deepseek = T.block_program(get_config("deepseek-moe-16b"))
    assert deepseek.head == (T.LayerSpec("attn"),)
    assert deepseek.superblock == (T.LayerSpec("attn", moe=True),)
    assert deepseek.n_superblocks == 27
    mixtral = T.block_program(get_config("mixtral-8x7b"))
    assert mixtral.superblock == (T.LayerSpec("attn", window=4096, moe=True),)
    minicpm = T.block_program(get_config("minicpm3-4b"))
    assert set(minicpm.layers()) == {T.LayerSpec("mla")}
    assert minicpm.n_layers == 62


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_logits_and_aux_match_jax(arch):
    jcfg, tcfg = config_pair(arch)
    jp, tp = weights_pair(jcfg, tcfg)
    toks = _tokens(0, 2, 32, jcfg.vocab_size)
    jl, _, jaux = jax_forward(jp, {"tokens": jnp.asarray(toks)}, cfg=jcfg,
                              ctx=CTX, mode="train")
    tt = torch.from_numpy(toks).long()
    tl, _ = forward(tp, {"tokens": tt}, cfg=tcfg, mode="train")
    assert tl.shape == (2, 32, jcfg.vocab_size)
    _close(tl, jl)
    _, _, taux = T.run_stack(tp["layers"], embed_tokens(tp, tt, tcfg),
                             cfg=tcfg, mode="train")
    n_moe = sum(s.moe for s in T.block_program(tcfg).layers())
    assert n_moe >= 1
    _close_fn(taux["moe_aux_loss"], jaux["moe_aux_loss"])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """Prefill fills the same cache; decode steps with a (B,) position
    vector and a scalar give the JAX logits."""
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
        assert tl.keys() == jl.keys() == {"k", "v"}
        for key in tl:
            _close(tl[key], jl[key].numpy())
    nxt = _tokens(2, 2, 3, jcfg.vocab_size)
    for i, pos in enumerate(([16, 11], [17, 12], 18)):
        jl, jc = jax_decode_step(jp, jnp.asarray(nxt[:, i:i + 1]), jc,
                                 jnp.asarray(pos, jnp.int32), cfg=jcfg,
                                 ctx=CTX)
        tl, tc = decode_step(tp, torch.from_numpy(nxt[:, i:i + 1]).long(),
                             tc, torch.tensor(pos, dtype=torch.int32),
                             cfg=tcfg)
        _close(tl, jl)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_prefill_decode_matches_forward(arch):
    """Prefill of S-1 tokens then one decode step == the teacher-forced
    forward's last two positions, as `tests/test_archs.py` holds the JAX
    package."""
    _, tcfg = config_pair(arch)
    tp = init_params(tcfg, seed=3, device="cpu")
    toks = torch.from_numpy(_tokens(4, 2, 32, tcfg.vocab_size)).long()
    full, _ = forward(tp, {"tokens": toks}, cfg=tcfg, mode="train")
    cache = init_cache(tcfg, 2, 64, device="cpu")
    last, cache = prefill(tp, {"tokens": toks[:, :31]}, cache, cfg=tcfg)
    torch.testing.assert_close(last, full[:, 30], **TOL)
    logits, _ = decode_step(tp, toks[:, 31:], cache, 31, cfg=tcfg)
    torch.testing.assert_close(logits, full[:, 31], **TOL)


def test_mixtral_rolling_window_decode_matches_full_and_jax():
    """Reduced mixtral keeps a rolling cache of 64 slots: decoding past
    the window through it == full attention with the window mask, and ==
    the JAX decode (as `tests/test_archs.py` rolls the JAX one)."""
    jcfg, tcfg = config_pair("mixtral-8x7b")
    assert tcfg.sliding_window == 64
    jp, tp = weights_pair(jcfg, tcfg)
    toks = _tokens(5, 1, 72, jcfg.vocab_size)
    tt = torch.from_numpy(toks).long()
    full, _ = forward(tp, {"tokens": tt}, cfg=tcfg, mode="train")
    tc = init_cache(tcfg, 1, 256, device="cpu")
    assert all(c["k"].shape[1] == 64 for c in tc)
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


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_init_params_matches_jax_layout_and_scales(arch):
    """`init_params` draws its own bits but has the JAX tree's layout
    (the head layer, the moe and MLA trees), dtypes and scales."""
    jcfg, tcfg = config_pair(arch)
    _, ref = weights_pair(jcfg, tcfg)
    got = init_params(tcfg, seed=0, device="cpu")
    flat_ref, flat_got = _flatten(ref), _flatten(got)
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


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------


ENGINE_REDUCED = dict(n_layers=2, d_model=128, vocab_size=512)


def _engine_pair(arch, moe_dispatch="dense", **kw):
    jcfg, tcfg = config_pair(arch, **ENGINE_REDUCED)
    jp, tp = weights_pair(jcfg, tcfg)
    kw.setdefault("max_batch", 3)
    kw.setdefault("max_seq", 128)
    ctx = cpu_context(remat=False, moe_dispatch=moe_dispatch)
    return (JaxEngine(jcfg, jp, ctx=ctx, **kw),
            ServingEngine(tcfg, tp, device="cpu", moe_dispatch=moe_dispatch,
                          **kw))


def _serve(eng, prompts, new=6):
    reqs = [eng.submit(p, max_new_tokens=new) for p in prompts]
    eng.run_until_idle()
    return [r.generated for r in reqs]


PROMPTS = [list(range(5, 12 + 3 * i)) for i in range(5)]


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "minicpm3-4b"])
def test_engine_greedy_tokens_match_jax(arch, paged):
    kw = dict(paged=True, kv_block_tokens=16) if paged else {}
    je, te = _engine_pair(arch, **kw)
    assert _serve(te, PROMPTS) == _serve(je, PROMPTS)
    assert te.stats() == je.stats()
    if paged:
        assert te.kv.free_blocks == te.kv.n_blocks


def test_engine_capacity_dispatch_matches_jax():
    """The engine's MoE layers run the capacity dispatch (prefill rows pack
    the padded bucket, decode rows one token each) as the JAX engine does
    under `ParallelContext(moe_dispatch="capacity")`."""
    je, te = _engine_pair("deepseek-moe-16b", moe_dispatch="capacity")
    dense = _engine_pair("deepseek-moe-16b")[1]
    toks = _serve(te, PROMPTS)
    assert toks == _serve(je, PROMPTS)
    assert len(toks) == len(PROMPTS) and all(len(t) == 6 for t in toks)
    assert te.moe_dispatch == "capacity" and dense.moe_dispatch == "dense"


def test_engine_rejects_an_unknown_dispatch():
    _, tcfg = config_pair("deepseek-moe-16b", **ENGINE_REDUCED)
    tp = init_params(tcfg, device="cpu")
    with pytest.raises(ValueError, match="moe_dispatch"):
        ServingEngine(tcfg, tp, device="cpu", moe_dispatch="all_to_all")
