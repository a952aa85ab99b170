"""The port's M-RoPE family (qwen2-vl-2b: the language backbone with
multimodal rotary positions and a stub vision projection) against the JAX
package on identical weights.

Reduced qwen2-vl-2b in float32; JAX weights reach the port through
`repro_torch.models.convert`. Tolerances: 2e-5 absolute and relative for
`apply_mrope`, 1e-4 for whole-model logits (the frameworks sum each
layer's products in different orders), greedy tokens exact for engines.
The engines pass three equal position streams, which reduce M-RoPE to
plain RoPE, so only distinct streams (here, to `apply_mrope` and the
forward) test the section bounds.
"""
import dataclasses

import jax  # noqa: F401  (both packages in one process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import config_pair, weights_pair
from repro.configs import get_config as jax_get_config
from repro.models import cpu_context
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import layers as JL
from repro.models import prefill as jax_prefill
from repro.serving import ServingEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.models import (
    decode_step, forward, init_cache, init_params, prefill,
)
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serving import ServingEngine

ARCH = "qwen2-vl-2b"
FN_TOL = dict(rtol=2e-5, atol=2e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
CTX = cpu_context(remat=False)


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s), np.int32)


def _streams(seed, b, s):
    """Three distinct (t, h, w) position streams, (3, B, S) int32."""
    rng = np.random.default_rng(seed)
    t = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    h = rng.integers(0, 40, (b, s)).astype(np.int32)
    w = rng.integers(0, 40, (b, s)).astype(np.int32)
    return np.stack([t, h, w])


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **tol)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
@pytest.mark.parametrize("d", [64, 128])
def test_apply_mrope_matches_jax_with_distinct_streams(d, theta):
    x = _normal(0, 2, 9, 3, d)
    pos3 = _streams(1, 2, 9)
    got = L.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3), theta)
    want = JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), theta)
    assert got.shape == x.shape and got.dtype == torch.float32
    _close(got, want, FN_TOL)


@pytest.mark.parametrize("d", [64, 128])
def test_apply_mrope_section_bounds(d):
    """Frequency slots [0, d/4) follow the t stream, [d/4, 3d/8) h and
    [3d/8, d/2) w: moving one stream moves exactly its slots' rotations."""
    half = d // 2
    x = torch.from_numpy(_normal(2, 1, 1, 1, d))
    base = torch.zeros(3, 1, 1, dtype=torch.int32)
    ref = L.apply_mrope(x, base, 1e4)
    for stream, (lo, hi) in enumerate(((0, half // 2),
                                       (half // 2, 3 * half // 4),
                                       (3 * half // 4, half))):
        pos = base.clone()
        pos[stream] = 5
        moved = (L.apply_mrope(x, pos, 1e4) != ref)[0, 0, 0]
        slots = moved[:half] | moved[half:]
        assert slots.nonzero().flatten().tolist() == list(range(lo, hi))


def test_apply_mrope_of_equal_streams_is_rope():
    x = torch.from_numpy(_normal(3, 2, 6, 2, 64))
    pos = torch.arange(6).expand(2, 6)
    torch.testing.assert_close(L.apply_mrope(x, pos.expand(3, 2, 6), 1e6),
                               L.apply_rope(x, pos, 1e6), rtol=0, atol=0)


def test_full_width_config_and_program():
    """qwen2-vl-2b: 28 attention layers, 12 q-heads on 2 kv-heads (G 6) at
    head_dim 128, a stub vision projection; its config is the JAX
    package's."""
    cfg = get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_get_config(ARCH))
    prog = T.block_program(cfg)
    assert prog.layers() == [T.LayerSpec("attn")] * 28
    assert cfg.n_heads // cfg.n_kv_heads == 6 and cfg.resolved_head_dim == 128
    assert cfg.mrope and cfg.vision_tokens == 256


def test_init_params_has_the_vision_projection():
    _, tcfg = config_pair(ARCH)
    _, ref = weights_pair(*config_pair(ARCH))
    got = init_params(tcfg, seed=0, device="cpu")
    assert got.keys() == ref.keys() and "vision_proj" in got
    assert got["vision_proj"].shape == ref["vision_proj"].shape \
        == (tcfg.d_model, tcfg.d_model)
    assert abs(got["vision_proj"].std().item() / 0.02 - 1) < 0.1


@pytest.mark.parametrize("vision", [False, True])
@pytest.mark.parametrize("streams", ["distinct", "none"])
def test_forward_logits_match_jax(vision, streams):
    """The forward with and without stub vision embeddings (projected over
    the first 8 positions), with distinct (3, B, S) streams or none."""
    jcfg, tcfg = config_pair(ARCH)
    jp, tp = weights_pair(jcfg, tcfg)
    toks = _tokens(0, 2, 24, jcfg.vocab_size)
    jb, tb = {"tokens": jnp.asarray(toks)}, \
        {"tokens": torch.from_numpy(toks).long()}
    if streams == "distinct":
        pos3 = _streams(1, 2, 24)
        jb["positions"], tb["positions"] = jnp.asarray(pos3), \
            torch.from_numpy(pos3)
    if vision:
        ve = _normal(2, 2, 8, jcfg.d_model)
        jb["vision_embeds"], tb["vision_embeds"] = jnp.asarray(ve), \
            torch.from_numpy(ve)
    jl, _, _ = jax_forward(jp, jb, cfg=jcfg, ctx=CTX, mode="train")
    tl, _ = forward(tp, tb, cfg=tcfg, mode="train")
    assert tl.shape == (2, 24, jcfg.vocab_size)
    _close(tl, jl)
    if vision:   # the splice reached the logits
        plain, _ = forward(tp, {"tokens": tb["tokens"]}, cfg=tcfg)
        assert not torch.allclose(plain[:, :8], tl[:, :8])


def test_prefill_and_decode_match_jax():
    """Prefill with distinct streams and vision embeddings, then decode
    steps whose (3, B, 1) positions come from pos, as the JAX package
    builds them, with (B,) and scalar positions."""
    jcfg, tcfg = config_pair(ARCH)
    jp, tp = weights_pair(jcfg, tcfg)
    toks = _tokens(3, 2, 20, jcfg.vocab_size)
    pos3 = _streams(4, 2, 16)
    ve = _normal(5, 2, 4, jcfg.d_model)
    jc = jax_init_cache(jcfg, 2, 32)
    tc = init_cache(tcfg, 2, 32, device="cpu")
    jlast, jc = jax_prefill(jp, {"tokens": jnp.asarray(toks[:, :16]),
                                 "positions": jnp.asarray(pos3),
                                 "vision_embeds": jnp.asarray(ve)}, jc,
                            cfg=jcfg, ctx=CTX)
    tlast, tc = prefill(tp, {"tokens": torch.from_numpy(toks[:, :16]).long(),
                             "positions": torch.from_numpy(pos3),
                             "vision_embeds": torch.from_numpy(ve)}, tc,
                        cfg=tcfg)
    _close(tlast, jlast)
    for i, t in enumerate(range(16, 20)):
        pos = t if i % 2 else [t, t - 3]
        jl, jc = jax_decode_step(jp, jnp.asarray(toks[:, t:t + 1]), jc,
                                 jnp.asarray(pos, jnp.int32), cfg=jcfg,
                                 ctx=CTX)
        tl, tc = decode_step(tp, torch.from_numpy(toks[:, t:t + 1]).long(),
                             tc, torch.tensor(pos, dtype=torch.int32),
                             cfg=tcfg)
        _close(tl, jl)


def test_prefill_decode_matches_forward():
    _, tcfg = config_pair(ARCH)
    tp = init_params(tcfg, seed=3, device="cpu")
    toks = torch.from_numpy(_tokens(6, 2, 24, tcfg.vocab_size)).long()
    full, _ = forward(tp, {"tokens": toks}, cfg=tcfg, mode="train")
    cache = init_cache(tcfg, 2, 32, device="cpu")
    pos3 = torch.arange(23).expand(3, 2, 23)
    last, cache = prefill(tp, {"tokens": toks[:, :23], "positions": pos3},
                          cache, cfg=tcfg)
    torch.testing.assert_close(last, full[:, 22], **TOL)
    logits, _ = decode_step(tp, toks[:, 23:], cache, 23, cfg=tcfg)
    torch.testing.assert_close(logits, full[:, 23], **TOL)


# ---------------------------------------------------------------------------
# the engine (text only: no JAX engine path passes vision embeddings)
# ---------------------------------------------------------------------------


def _engines(**kw):
    jcfg, tcfg = config_pair(ARCH, n_layers=2, d_model=128, vocab_size=512)
    jp, tp = weights_pair(jcfg, tcfg)
    kw = dict(max_batch=3, max_seq=64, **kw)
    return JaxEngine(jcfg, jp, ctx=CTX, **kw), \
        ServingEngine(tcfg, tp, device="cpu", **kw)


@pytest.mark.parametrize("paged", [False, True])
def test_engine_greedy_tokens_match_jax_engine(paged):
    """Prefill with the (3, 1, S) streams of the JAX engine, then decode;
    dense and paged."""
    kw = dict(paged=True, kv_block_tokens=16) if paged else {}
    out = []
    for eng in _engines(**kw):
        for i, n in enumerate((3, 6, 11, 17, 23)):
            eng.submit([(13 * i + 5 * j) % 512 for j in range(n)],
                       max_new_tokens=7)
        done = sorted(eng.run_until_idle(), key=lambda r: r.rid)
        out.append(([r.generated for r in done], eng.stats()))
    assert out[0] == out[1]
    assert all(len(g) == 7 for g in out[1][0])


def test_paged_engine_prefix_hit_matches_jax():
    """A prompt opening with an earlier prompt's two full blocks attaches
    them and decodes only its suffix through M-RoPE decode steps."""
    head = [(5 * j + 2) % 512 for j in range(32)]
    prompts = [head + [9, 8, 7], head + [1, 2, 3, 4], [4, 5, 6]]
    out = []
    for eng in _engines(paged=True, kv_block_tokens=16):
        for p in prompts:
            eng.submit(p, max_new_tokens=6)
            eng.run_until_idle()
        out.append(([r.generated for r in eng.completed], eng.stats()))
        assert eng.n_prefix_hits == 1 and eng.prefix_tokens_reused == 32
    assert out[0] == out[1]
