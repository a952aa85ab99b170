"""The port's encoder-decoder family (whisper-base) against the JAX package
on identical weights: the sinusoidal positions, the encoder, the cross
attention branch, forward, prefill and decode.

Reduced float32 configs (2 encoder and 2 decoder layers, 32 encoder
slots); the audio frames are made in the model's dtype with numpy and
handed to both packages. Tolerance: 1e-4 absolute and relative on float32
values, as in tests/test_torch_model.py (the two frameworks sum the matrix
products in different orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import config_pair, numpy_tree, weights_pair
from repro.models import cpu_context
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import layers as JL
from repro.models import prefill as jax_prefill
from repro.models import transformer as JT
from repro_torch.models import (
    decode_step, forward, init_cache, init_params, prefill,
)
from repro_torch.models import layers as L
from repro_torch.models.model import greedy_generate
from repro_torch.models import transformer as T
from repro_torch.models.convert import (
    cache_from_jax, params_from_jax, params_to_jax,
)
from repro_torch.serving import ServingEngine

TOL = dict(rtol=1e-4, atol=1e-4)
CTX = cpu_context(remat=False)


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


def _inputs(cfg, seed, b, s, frames):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    audio = rng.standard_normal((b, frames, cfg.d_model)).astype(np.float32)
    return toks, audio


def _batches(toks, audio):
    return ({"tokens": jnp.asarray(toks), "audio_frames": jnp.asarray(audio)},
            {"tokens": torch.from_numpy(toks).long(),
             "audio_frames": torch.from_numpy(audio)})


@pytest.fixture(scope="module")
def whisper():
    jcfg, tcfg = config_pair("whisper-base")
    assert tcfg.enc_dec and tcfg.n_encoder_layers == 2
    assert tcfg.encoder_seq_len == 32
    jp, tp = weights_pair(jcfg, tcfg)
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("seq,d", [(32, 256), (1500, 512), (7, 64)])
def test_sinusoidal_positions_match_jax(seq, d):
    got = T.sinusoidal_positions(seq, d)
    assert got.shape == (1, seq, d) and got.dtype == torch.float32
    _close(got, JT.sinusoidal_positions(seq, d))


def test_run_encoder_matches_jax(whisper):
    jcfg, tcfg, jp, tp = whisper
    _, audio = _inputs(tcfg, 0, 2, 4, 32)
    want = JT.run_encoder(jp["encoder"], jnp.asarray(audio), cfg=jcfg,
                          ctx=CTX)
    got = T.run_encoder(tp["encoder"], torch.from_numpy(audio), cfg=tcfg)
    assert got.shape == (2, 32, tcfg.d_model)
    _close(got, want)


@pytest.mark.parametrize("cached", [False, True])
def test_cross_attention_matches_jax(whisper, cached):
    """The cross branch: queries from x, keys and values from the encoder
    output (projected in the layer) or from their cache; no RoPE, no
    mask. It returns the keys and values as its cache."""
    jcfg, tcfg, jp, tp = whisper
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, tcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 24, tcfg.d_model)).astype(np.float32)
    jparams = jax.tree.map(lambda a: a[0], jp["stack"]["sb"][0]["cross"])
    tparams = tp["layers"][0]["cross"]
    jout, jkv = JL.attention_layer(jparams, jnp.asarray(x), cfg=jcfg,
                                   ctx=CTX, mode="prefill",
                                   enc_out=jnp.asarray(enc), causal=False)
    tout, tkv = L.attention_layer(tparams, torch.from_numpy(x), cfg=tcfg,
                                  mode="prefill",
                                  enc_out=torch.from_numpy(enc), causal=False)
    if cached:
        jout, _ = JL.attention_layer(jparams, jnp.asarray(x[:, :1]),
                                     cfg=jcfg, ctx=CTX, mode="decode",
                                     enc_cache=jkv, causal=False)
        cache = {k: torch.from_numpy(np.array(v)) for k, v in jkv.items()}
        tout, tkv2 = L.attention_layer(tparams, torch.from_numpy(x[:, :1]),
                                       cfg=tcfg, mode="decode",
                                       enc_cache=cache, causal=False)
        assert tkv2["k"] is cache["k"] and tkv2["v"] is cache["v"]
    else:
        assert tkv["k"].shape == (2, 24, tcfg.n_kv_heads,
                                  tcfg.resolved_head_dim)
        _close(tkv["k"], jkv["k"])
        _close(tkv["v"], jkv["v"])
    _close(tout, jout)


def test_encoder_attention_is_unrotated_and_bidirectional(whisper):
    """mode="encode" with causal=False: the output at position 0 depends on
    later positions, and shifting the positions argument changes nothing
    (no RoPE)."""
    _, tcfg, _, tp = whisper
    p = tp["encoder"]["layers"][0]["mix"]
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, 6, tcfg.d_model)).astype(np.float32))
    out, _ = L.attention_layer(p, x, cfg=tcfg, mode="encode", causal=False)
    x2 = x.clone()
    x2[:, -1] += 1.0
    out2, _ = L.attention_layer(p, x2, cfg=tcfg, mode="encode", causal=False)
    assert not torch.allclose(out[:, 0], out2[:, 0])
    shifted, _ = L.attention_layer(
        p, x, cfg=tcfg, mode="encode", causal=False,
        positions=torch.arange(6)[None] + 100)
    torch.testing.assert_close(shifted, out)


def test_forward_matches_jax(whisper):
    jcfg, tcfg, jp, tp = whisper
    toks, audio = _inputs(tcfg, 3, 2, 16, 32)
    jb, tb = _batches(toks, audio)
    jl, _, _ = jax_forward(jp, jb, cfg=jcfg, ctx=CTX, mode="train")
    tl, _ = forward(tp, tb, cfg=tcfg, mode="train")
    assert tl.shape == (2, 16, tcfg.vocab_size)
    _close(tl, jl)


def test_prefill_and_decode_match_jax(whisper):
    """Prefill fills the self-attention cache and the cross keys and values;
    decode steps (the frames passed as ``batch_extras``, as the JAX tests
    pass them, and not re-encoded) give the JAX logits, with a scalar and
    with a (B,) position."""
    jcfg, tcfg, jp, tp = whisper
    toks, audio = _inputs(tcfg, 4, 2, 12, 32)
    jb, tb = _batches(toks, audio)
    jc = jax_init_cache(jcfg, 2, 64)
    tc = init_cache(tcfg, 2, 64, device="cpu")
    jlast, jc = jax_prefill(jp, jb, jc, cfg=jcfg, ctx=CTX)
    tlast, tc = prefill(tp, tb, tc, cfg=tcfg)
    _close(tlast, jlast)
    for tl, jl in zip(tc, cache_from_jax(numpy_tree(jc), tcfg, "cpu"),
                      strict=True):
        assert tl.keys() == jl.keys() == {"k", "v", "cross_k", "cross_v"}
        for key in tl:
            _close(tl[key], jl[key].numpy())
    nxt = np.random.default_rng(5).integers(0, tcfg.vocab_size, (2, 3))
    for i, pos in enumerate((12, [13, 13], 14)):
        jl, jc = jax_decode_step(
            jp, jnp.asarray(nxt[:, i:i + 1], jnp.int32), jc,
            jnp.asarray(pos, jnp.int32), cfg=jcfg, ctx=CTX,
            batch_extras={"audio_frames": jb["audio_frames"]})
        tl, tc = decode_step(
            tp, torch.from_numpy(nxt[:, i:i + 1]).long(), tc,
            torch.tensor(pos, dtype=torch.int32), cfg=tcfg,
            batch_extras={"audio_frames": tb["audio_frames"]})
        _close(tl, jl)


def test_greedy_generate_matches_jax_prefill_and_decode(whisper):
    """`greedy_generate` (each prompt prefilled alone, then the rows decoded
    together at their own positions) gives the tokens of JAX prefill and
    decode_step run one request at a time."""
    jcfg, tcfg, jp, tp = whisper
    rng = np.random.default_rng(8)
    prompts = [[int(t) for t in rng.integers(0, tcfg.vocab_size, n)]
               for n in (4, 9, 13)]
    audio = rng.standard_normal((3, 32, tcfg.d_model)).astype(np.float32)
    got = greedy_generate(tp, prompts, cfg=tcfg, steps=4, max_seq=32,
                          extras={"audio_frames": torch.from_numpy(audio)})
    for i, prompt in enumerate(prompts):
        logits, cache = jax_prefill(
            jp, {"tokens": jnp.asarray([prompt], jnp.int32),
                 "audio_frames": jnp.asarray(audio[i:i + 1])},
            jax_init_cache(jcfg, 1, 32), cfg=jcfg, ctx=CTX)
        want = [int(jnp.argmax(logits[0]))]
        for step in range(4):
            logits, cache = jax_decode_step(
                jp, jnp.asarray([[want[-1]]], jnp.int32), cache,
                jnp.int32(len(prompt) + step), cfg=jcfg, ctx=CTX)
            want.append(int(jnp.argmax(logits[0])))
        assert got[i] == want


@pytest.mark.parametrize("frames", [32, 24])
def test_cross_cache_takes_the_frames_length(whisper, frames):
    """Prefill replaces the cross_k/cross_v entries (encoder_seq_len slots)
    with the encoder's keys and values at the frames' own length, as the
    JAX package does: 24 frames attend over 24 keys, not 32 with zeros."""
    jcfg, tcfg, jp, tp = whisper
    toks, audio = _inputs(tcfg, 6, 1, 8, frames)
    jb, tb = _batches(toks, audio)
    tc = init_cache(tcfg, 1, 32, device="cpu")
    assert tc[0]["cross_k"].shape[1] == tcfg.encoder_seq_len == 32
    _, tc = prefill(tp, tb, tc, cfg=tcfg)
    _, jc = jax_prefill(jp, jb, jax_init_cache(jcfg, 1, 32), cfg=jcfg,
                        ctx=CTX)
    assert jc["sb"][0]["cross_k"].shape[2] == frames
    for layer in tc:
        assert layer["cross_k"].shape[1] == layer["cross_v"].shape[1] == frames
    full, _ = forward(tp, tb, cfg=tcfg, mode="train")
    nxt = torch.tensor([[7]])
    logits, _ = decode_step(tp, nxt, tc, 8, cfg=tcfg)
    want, _ = forward(tp, {"tokens": torch.cat([tb["tokens"], nxt], 1),
                           "audio_frames": tb["audio_frames"]}, cfg=tcfg)
    torch.testing.assert_close(logits, want[:, -1], **TOL)
    torch.testing.assert_close(full, want[:, :-1], **TOL)


def test_engine_refuses_encoder_decoder(whisper):
    """The JAX engine cannot serve whisper (its prefill batch has no audio
    frames); the port's engine refuses it rather than invent a path."""
    _, tcfg, _, tp = whisper
    with pytest.raises(ValueError, match="encoder-decoder"):
        ServingEngine(tcfg, tp, max_batch=1, max_seq=32, device="cpu")


def test_frames_of_another_dtype_raise(whisper):
    _, tcfg, _, tp = whisper
    toks, audio = _inputs(tcfg, 7, 1, 4, 32)
    with pytest.raises(TypeError, match="audio_frames"):
        forward(tp, {"tokens": torch.from_numpy(toks).long(),
                     "audio_frames": torch.from_numpy(audio).bfloat16()},
                cfg=tcfg)


@pytest.mark.parametrize("arch", ["whisper-base", "deepseek-moe-16b",
                                  "recurrentgemma-2b", "qwen2-vl-2b"])
def test_params_to_jax_round_trip(arch):
    """params_to_jax restacks the port's per-layer parameters into the JAX
    tree (the superblocks, a head layer, a tail, the encoder): the JAX
    weights come back leaf for leaf, and the JAX model runs on them."""
    jcfg, tcfg = config_pair(arch, n_layers=5 if arch.startswith("recur")
                             else 2)
    jp, tp = weights_pair(jcfg, tcfg)
    back = params_to_jax(tp, tcfg)
    want = numpy_tree(jp)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want),
                    strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    again = params_from_jax(back, tcfg, device="cpu")
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(tp), strict=True):
        assert torch.equal(a, b)


def test_params_to_jax_gives_bfloat16_bits():
    jcfg, tcfg = config_pair("whisper-base")
    bf = jcfg.__class__(**{**jcfg.__dict__, "dtype": "bfloat16"})
    jp = jax_init_params(jax.random.key(0), bf)
    tcfg_bf = tcfg.__class__(**{**tcfg.__dict__, "dtype": "bfloat16"})
    tp = params_from_jax(numpy_tree(jp), tcfg_bf, device="cpu")
    assert tp["embed"].dtype == torch.bfloat16
    back = params_to_jax(tp, tcfg_bf)
    assert back["embed"].dtype == np.uint16
    np.testing.assert_array_equal(
        back["embed"], np.asarray(jp["embed"]).view(np.uint16))


def test_init_params_matches_jax_layout(whisper):
    """`init_params` draws its own bits in the JAX tree's layout: the
    encoder's layers and norm and each decoder layer's cross sublayer."""
    _, tcfg, _, tp = whisper
    got = init_params(tcfg, seed=0, device="cpu")
    assert len(got["encoder"]["layers"]) == tcfg.n_encoder_layers
    flat_ref = jax.tree_util.tree_flatten_with_path(tp)[0]
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_ref] == [p for p, _ in flat_got]
    for (_, r), (_, g) in zip(flat_ref, flat_got, strict=True):
        assert g.shape == r.shape and g.dtype == r.dtype
