"""DeepSeek-V2-Lite's block on the port, against the plain reference
(`_deepseek_v2_reference.py`) at small widths on seeded random weights:
MLA without q-LoRA, YaRN rope, the published gate rule, prefill and decode
through the latent cache, the serving engine with its counters and ranges;
and the settings object (`models.block.Block`) leaving every other model
as it was."""
import dataclasses
import math
import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import _deepseek_v2_reference as REF
from repro_torch.configs.base import MLAConfig, ModelConfig
from repro_torch.models import block as BL
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.obs import spans as SP
from repro_torch.serving import ServingEngine

ROPE_SCALING = {"beta_fast": 32, "beta_slow": 1, "factor": 40,
                "mscale": 0.707, "mscale_all_dim": 0.707,
                "original_max_position_embeddings": 4096, "type": "yarn"}
# the published keys the reference reads, at the widths of the CPU tests
SMALL = {"hidden_size": 64, "intermediate_size": 96, "num_hidden_layers": 3,
         "num_attention_heads": 4, "kv_lora_rank": 32,
         "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
         "moe_intermediate_size": 32, "n_routed_experts": 8,
         "num_experts_per_tok": 2, "n_shared_experts": 1,
         "vocab_size": 256, "first_k_dense_replace": 1,
         "norm_topk_prob": False, "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
         "rope_scaling": ROPE_SCALING}
MAX_SEQ = 64
# float32 against float32: the port and the reference differ in the order
# of their sums (the flash plain version's blocks, the absorbed decode,
# the dense dispatch's einsum over every expert), ~1e-6 of logits of size
# ~1; a bfloat16 run misses by ~1e-2 (`test_a_bfloat16_run_misses_the_
# tolerance`)
TOL = 1e-4


def _port_cfg(c: dict, dtype: str = "float32") -> ModelConfig:
    return ModelConfig(
        arch_id="deepseek-v2-lite-small", family="moe",
        n_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
        n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_attention_heads"], head_dim=c["qk_nope_head_dim"],
        d_ff=c["intermediate_size"], vocab_size=c["vocab_size"],
        norm_eps=c["rms_norm_eps"], rope_theta=c["rope_theta"],
        n_experts=c["n_routed_experts"],
        n_shared_experts=c["n_shared_experts"],
        top_k=c["num_experts_per_tok"],
        moe_d_ff=c["moe_intermediate_size"],
        mla=MLAConfig(q_lora_rank=0, kv_lora_rank=c["kv_lora_rank"],
                      qk_nope_head_dim=c["qk_nope_head_dim"],
                      qk_rope_head_dim=c["qk_rope_head_dim"],
                      v_head_dim=c["v_head_dim"]),
        dtype=dtype)


def _block(c: dict) -> BL.Block:
    rs = c["rope_scaling"]
    return BL.Block(
        norm_topk_prob=c["norm_topk_prob"],
        rope_scaling=BL.YaRN(
            factor=rs["factor"],
            original_max_position_embeddings=rs[
                "original_max_position_embeddings"],
            beta_fast=rs["beta_fast"], beta_slow=rs["beta_slow"],
            mscale=rs["mscale"], mscale_all_dim=rs["mscale_all_dim"]))


def _params(cfg: ModelConfig, seed: int = 3):
    """The port's weights with every norm scale and the router drawn too
    (they start at zero and 0.02), so that each takes part."""
    params = M.init_params(cfg, seed=seed, device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)

    def walk(node):
        for key, val in node.items():
            if isinstance(val, dict):
                walk(val)
            elif key == "scale":
                val.copy_(0.1 * torch.randn(val.shape, generator=gen))
            elif key == "router":
                val.copy_(0.5 * torch.randn(val.shape, generator=gen))
    for layer in params["layers"]:
        walk(layer)
    walk({"final_norm": params["final_norm"]})
    return params


@pytest.fixture(scope="module")
def model():
    cfg = _port_cfg(SMALL)
    return cfg, _params(cfg), _block(SMALL)


def _prompt(n, seed=0):
    return torch.randint(0, SMALL["vocab_size"], (n,),
                         generator=torch.Generator().manual_seed(seed))


def _prefill_decode(cfg, params, block, prompt, steps=8):
    """The port's logits: prefill's last row, then `steps` greedy decode
    steps through the cache. Returns (the generated tokens, [logits])."""
    cache = M.init_cache(cfg, 1, MAX_SEQ, device="cpu")
    logits, cache = M.prefill(params, {"tokens": prompt[None]}, cache,
                              cfg=cfg, last=len(prompt) - 1, block=block)
    out, toks = [logits[0]], []
    for i in range(steps):
        tok = out[-1].argmax()
        toks.append(int(tok))
        pos = torch.tensor([len(prompt) + i])
        logits, cache = M.decode_step(params, tok.view(1, 1), cache, pos,
                                      cfg=cfg, block=block)
        out.append(logits[0])
    return toks, out


def test_prefill_and_decode_through_the_cache_match_the_reference(model):
    cfg, params, block = model
    prompt = _prompt(21)
    toks, got = _prefill_decode(cfg, params, block, prompt)
    seq = torch.cat([prompt, torch.tensor(toks)])
    want = REF.logits(params, SMALL, seq)
    for i, g in enumerate(got):
        torch.testing.assert_close(g, want[len(prompt) - 1 + i], rtol=TOL,
                                   atol=TOL)


def test_a_bfloat16_run_misses_the_tolerance(model):
    cfg, params, block = model
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    p16 = _cast(params, torch.bfloat16)
    prompt = _prompt(21)
    _, got = _prefill_decode(cfg16, p16, block, prompt, steps=0)
    want = REF.logits(params, SMALL, prompt)[-1]
    assert (got[0] - want).abs().max().item() > 10 * TOL


def _cast(tree, dt):
    """The matrices in `dt`; norm scales and the router stay float32, as
    the port keeps them."""
    if isinstance(tree, dict):
        return {k: (v if k in ("scale", "router") else _cast(v, dt))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dt) for v in tree]
    return tree.to(dt)


def test_the_engine_emits_the_references_best_tokens(model):
    """Three slots, prompts of different lengths (three buckets), more
    requests than slots: each emitted token's reference logit lies within
    GAP of the reference's best at its position (the port's float32 logits
    differ by ~1e-6, so greedy picks the best or a near tie)."""
    gap = 1e-3
    cfg, params, block = model
    eng = ServingEngine(cfg, params, max_batch=3, max_seq=MAX_SEQ,
                        device="cpu", block=block)
    prompts = [_prompt(n, seed=n) for n in (5, 17, 33, 9)]
    reqs = [eng.submit(p.tolist(), max_new_tokens=6) for p in prompts]
    eng.run_until_idle()
    for p, r in zip(prompts, reqs, strict=True):
        assert len(r.generated) == 6
        seq = torch.cat([p, torch.tensor(r.generated[:-1])])
        ref = REF.logits(params, SMALL, seq)[len(p) - 1:]
        best = ref.max(-1).values
        mine = ref[torch.arange(6), torch.tensor(r.generated)]
        assert (best - mine).max().item() <= gap


def test_yarn_at_the_published_sizes():
    """low and high of the ramp, the blended frequencies and the softmax
    scale of the published rope_scaling, against the formulas written out
    (DeepSeek-V2's modelling code)."""
    y = _block(SMALL).rope_scaling
    dim, base = 64, 10000.0
    assert y.correction_range(dim, base) == (10, 23)
    low, high = 10, 23
    got = y.inv_freq(dim, base)
    for i in range(dim // 2):
        extra = 1.0 / base ** (2 * i / dim)
        inter = extra / 40
        m = 1 - min(max((i - low) / (high - low), 0.0), 1.0)
        assert math.isclose(got[i].item(), inter * (1 - m) + extra * m,
                            rel_tol=1e-6), i
    ms = 0.1 * 0.707 * math.log(40) + 1
    assert y.cos_sin_scale == 1.0                  # mscale == mscale_all_dim
    assert math.isclose(y.softmax_factor, ms * ms, rel_tol=1e-12)
    cfg = _port_cfg(dict(SMALL, qk_nope_head_dim=128, qk_rope_head_dim=64))
    scale = L.mla_softmax_scale(cfg, _block(SMALL))
    assert round(scale, 6) == 0.114721
    assert math.isclose(scale, 192 ** -0.5 * 1.5896, rel_tol=1e-4)
    other = dataclasses.replace(y, mscale=1.0)
    assert math.isclose(other.cos_sin_scale,
                        (0.1 * math.log(40) + 1) / ms, rel_tol=1e-12)
    torch.testing.assert_close(got, REF.yarn_inv_freq(SMALL["rope_scaling"],
                                                      dim, base))


def test_yarn_rotation_matches_the_reference(model):
    cfg, _, block = model
    x = torch.randn(1, 40, 3, 8, generator=torch.Generator().manual_seed(2))
    got = L.mla_rope(x, torch.arange(40)[None], cfg, block)
    rs = SMALL["rope_scaling"]
    want = REF.rope(x[0], REF.yarn_inv_freq(rs, 8, 10000.0), 1.0)
    torch.testing.assert_close(got[0], want, rtol=1e-6, atol=1e-6)
    plain = L.mla_rope(x, torch.arange(40)[None], cfg)
    assert not torch.allclose(plain, got, atol=1e-3)


@pytest.mark.parametrize("norm", [False, True])
def test_the_gate_rule_matches_the_reference(model, norm):
    cfg, params, _ = model
    p = params["layers"][1]["moe"]
    x = torch.randn(2, 7, SMALL["hidden_size"],
                    generator=torch.Generator().manual_seed(4))
    blk = BL.Block(norm_topk_prob=norm)
    got, _ = MOE.moe_layer(p, x, cfg=cfg, block=blk)
    c = dict(SMALL, norm_topk_prob=norm)
    want = REF.moe(x.reshape(-1, x.shape[-1]), p, c).view_as(x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    if not norm:
        jax_rule, _ = MOE.moe_layer(p, x, cfg=cfg)
        assert not torch.allclose(jax_rule, got, atol=1e-3)
    cap, _ = MOE.moe_layer_capacity(p, x, cfg=cfg, block=blk,
                                    capacity_factor=8.0)
    torch.testing.assert_close(cap, got, rtol=1e-5, atol=1e-5)


def test_without_settings_the_result_is_todays_to_the_bit(model):
    """No block (or the default one) is the JAX package's rule: the gates
    renormalised (router_probs' former expression), plain rope, the plain
    softmax scale."""
    cfg, params, _ = model
    p = params["layers"][1]["moe"]
    x = torch.randn(9, SMALL["hidden_size"],
                    generator=torch.Generator().manual_seed(5))
    _, gates, _ = MOE.router_probs(p, x, cfg)
    probs = torch.softmax(x.float() @ p["router"], dim=-1)
    topv, _ = torch.topk(probs, cfg.top_k, dim=-1)
    assert torch.equal(gates, topv / topv.sum(dim=-1, keepdim=True))
    xb = x[None]
    none, _ = MOE.moe_layer(p, xb, cfg=cfg)
    default, _ = MOE.moe_layer(p, xb, cfg=cfg, block=BL.Block())
    assert torch.equal(none, default)
    prompt = _prompt(13)[None]
    outs = [M.prefill(params, {"tokens": prompt},
                      M.init_cache(cfg, 1, MAX_SEQ, device="cpu"), cfg=cfg,
                      **kw)[0] for kw in ({}, {"block": BL.Block()})]
    assert torch.equal(*outs)
    assert L.mla_softmax_scale(cfg, BL.Block()) == 1.0 / math.sqrt(24)


def test_the_reference_and_the_harness_family_agree(model):
    """The harness's copy of the reference (its float32 logits, layer by
    layer) and this one, on the same weights: they cannot drift apart."""
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    from cardbench.core import registry
    fam = registry.family({"model_type": "deepseek_v2"})
    _, params, _ = model
    prompt = _prompt(30, seed=7)
    c = dict(SMALL, q_lora_rank=None, torch_dtype="float32")
    got = fam.logits(params, c, [prompt, prompt[:11]], [(0, 30), (4, 7)])
    want = REF.logits(params, SMALL, prompt)
    # the same float32 sums in another order (blocks of rows, sequences
    # joined for the MLP): TOL, a tenth of a bfloat16 ulp at these logits
    torch.testing.assert_close(got[0], want, rtol=TOL, atol=TOL)
    torch.testing.assert_close(got[1], REF.logits(params, SMALL,
                                                  prompt[:11])[4:],
                               rtol=TOL, atol=TOL)


def test_the_counters_count_rows_and_positions(model):
    """One request of 5 tokens (bucket 8) and 3 new tokens: a prefill and
    two decode steps of the 3 slots, on 2 MoE layers of 8 experts (top 2)
    and 3 MLA layers."""
    cfg, params, block = model
    eng = ServingEngine(cfg, params, max_batch=3, max_seq=MAX_SEQ,
                        device="cpu", block=block)
    eng.submit(_prompt(5).tolist(), max_new_tokens=3)
    eng.run_until_idle()
    got = {k: eng.metrics.get(f"engine.{k}")
           for k in ("moe_expert_rows", "moe_routed_rows",
                     "mla_decode_positions", "mla_valid_positions")}
    assert got == {"moe_expert_rows": 2 * 8 * (8 + 2 * 3),
                   "moe_routed_rows": 2 * 2 * (8 + 2 * 3),
                   "mla_decode_positions": 3 * 2 * 3 * MAX_SEQ,
                   "mla_valid_positions": 3 * ((5 + 1) + (6 + 1))}
    cap = ServingEngine(cfg, params, max_batch=3, max_seq=MAX_SEQ,
                        device="cpu", block=block, moe_dispatch="capacity")
    cap.submit(_prompt(5).tolist(), max_new_tokens=1)
    cap.run_until_idle()
    # capacity: an (E, C) buffer a row, C = ceil(2 * 8 / 8 * 1.25) = 3
    assert cap.metrics.get("engine.moe_expert_rows") == 2 * 8 * 3


def test_the_mla_and_moe_ranges_show_under_the_profiler(model):
    cfg, params, block = model
    eng = ServingEngine(cfg, params, max_batch=3, max_seq=MAX_SEQ,
                        device="cpu", block=block)
    eng.spans = SP.SpanLog()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.submit(_prompt(9).tolist(), max_new_tokens=3)
        eng.run_until_idle()
    names = {e.name for e in prof.events()}
    assert {"model.mla.expand", "model.mla.attend", "model.moe.route",
            "model.moe.experts", "model.moe.shared"} <= names


def test_settings_the_model_cannot_take_are_refused(model):
    cfg, params, block = model
    from repro_torch.configs import get_config
    dense = dataclasses.replace(get_config("yi-6b").reduced(),
                                dtype="float32")
    with pytest.raises(ValueError, match="rope_scaling"):
        block.check(dense)
    with pytest.raises(ValueError, match="gate rule"):
        BL.Block(norm_topk_prob=False).check(dense)
    from repro_torch.models import parallel as PAR
    from repro_torch.models import tp as TP
    from repro_torch.models import transformer as T
    ctx = PAR.ParallelContext(mesh=PAR.Mesh.abstract((1, 2),
                                                     ("data", "model")))
    x = torch.zeros(1, 4, SMALL["hidden_size"])
    spec = T.block_program(cfg).layers()[1]
    with pytest.raises(NotImplementedError, match="block settings"):
        T.apply_layer(spec, params["layers"][1], x, cfg=cfg, mode="train",
                      ctx=ctx, block=block)
    with pytest.raises(NotImplementedError, match="q_lora_rank 0"):
        TP.mla_layer(params["layers"][0]["mix"], x, cfg=cfg, ctx=ctx,
                     mode="train")


def test_q_lora_layers_keep_their_leaves(model):
    """q_lora_rank 0 draws one wq and no query norm; a q-LoRA MLA keeps
    wq_a, wq_b and q_norm, drawn in the same order as before."""
    cfg, params, _ = model
    assert set(params["layers"][0]["mix"]) == {"wq", "wkv_a", "wkv_b", "wo",
                                              "kv_norm"}
    lora = dataclasses.replace(cfg, mla=dataclasses.replace(cfg.mla,
                                                            q_lora_rank=24))
    p = L.init_mla(torch.Generator().manual_seed(0), lora)
    assert list(p) == ["wq_a", "wq_b", "wkv_a", "wkv_b", "wo", "q_norm",
                       "kv_norm"]
