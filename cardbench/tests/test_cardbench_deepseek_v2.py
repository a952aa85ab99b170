"""The ``deepseek_v2`` family (DeepSeek-V2-Lite): its weight layout and work
counts against the published shapes and hand counts, a cell cut small run
whole on the CPU, the port's settings object built from the file, and a
port without one refused."""
import time

import pytest

from cardbench.core import cell as C
from cardbench.core import port, registry, work
from cardbench.tests import tiny

NAME = "deepseek-v2-lite"


def _published():
    return registry.load_json(registry.BENCH_DIR / "configs"
                              / f"{NAME}.json")


def test_the_file_names_its_family_and_keeps_its_widths():
    cfg = _published()
    fam = registry.family(cfg)
    assert fam.__file__.endswith("families/deepseek_v2.py")
    assert cfg["reduced"] == [] and cfg["q_lora_rank"] is None
    s = fam.shape(cfg)
    assert (s.layers, s.dense_layers, s.d, s.heads, s.nope, s.rope, s.v,
            s.rank, s.ff, s.vocab, s.experts, s.top_k, s.moe_ff,
            s.shared) == (27, 1, 2048, 16, 128, 64, 128, 512, 10944, 102400,
                          64, 6, 1408, 2)
    assert s.kv_bytes_per_token == 27 * 576 * 2 == 31104


def test_layout_is_the_published_shapes():
    s = registry.family(_published()).shape(_published())
    lay = {p: (sh, dt) for p, sh, _, dt in s.layout()}
    assert lay[("embed",)] == ((102400, 2048), "bfloat16")
    assert lay[("unembed",)] == ((102400, 2048), "bfloat16")
    mix = {k[-1]: v for k, v in lay.items() if k[:3] == ("layers", 5, "mix")}
    assert mix == {"wq": ((2048, 16 * 192), "bfloat16"),
                   "wkv_a": ((2048, 512 + 64), "bfloat16"),
                   "wkv_b": ((512, 16 * (128 + 128)), "bfloat16"),
                   "wo": ((16 * 128, 2048), "bfloat16"),
                   "scale": ((512,), "float32")}
    assert lay[("layers", 0, "mlp", "w_gate")] == ((2048, 10944), "bfloat16")
    assert ("layers", 0, "moe", "router") not in lay
    assert lay[("layers", 1, "moe", "router")] == ((2048, 64), "float32")
    assert lay[("layers", 26, "moe", "we_down")] == ((64, 1408, 2048),
                                                      "bfloat16")
    assert lay[("layers", 26, "moe", "shared", "w_up")] == (
        (2048, 2 * 1408), "bfloat16")
    total = sum(_prod(sh) for sh, _ in lay.values())
    # 15.7 B parameters (the model card's "16B"), 31.4 GB in bfloat16
    assert 15.6e9 < total < 15.8e9


def _prod(shape):
    out = 1
    for n in shape:
        out *= n
    return out


def test_work_counts_by_hand():
    s = registry.family(_published()).shape(_published())
    attn = (2048 * 3072 + 2048 * 576 + 512 * 4096 + 2048 * 2048)
    dense = 3 * 2048 * 10944
    moe = 2048 * 64 + 3 * 2048 * 1408 * (2 + 6)
    assert s.body_params == 27 * attn + dense + 26 * moe == 2_241_593_344
    assert s.head_params == 102400 * 2048
    # causal pairs of 100 tokens, scores at qk 192 and values at v 128
    flops, nbytes = work.flash_work(s, 100)
    assert flops == 2 * 27 * 16 * (192 + 128) * (100 * 101 // 2)
    assert nbytes == 27 * 100 * 16 * (2 * 192 + 2 * 128) * 2
    flops, nbytes = work.decode_work(s, [10, 30])
    assert flops == 2 * 27 * 16 * 320 * 40
    assert nbytes == 27 * 2 * (576 * 40 + 16 * 320 * 2)


def test_engine_args_are_the_published_settings():
    cfg = _published()
    fam = registry.family(cfg)
    blk = fam.engine_args(cfg)["block"]
    assert blk.norm_topk_prob is False
    y = blk.rope_scaling
    assert (y.factor, y.original_max_position_embeddings, y.beta_fast,
            y.beta_slow, y.mscale, y.mscale_all_dim) == (40, 4096, 32, 1,
                                                         0.707, 0.707)
    pc = fam.port_config(cfg)
    assert (pc.mla.q_lora_rank, pc.mla.kv_lora_rank,
            pc.mla.qk_nope_head_dim, pc.mla.qk_rope_head_dim,
            pc.mla.v_head_dim) == (0, 512, 128, 64, 128)
    assert (pc.d_ff, pc.moe_d_ff, pc.n_experts, pc.top_k,
            pc.n_shared_experts, pc.n_layers) == (10944, 1408, 64, 6, 2, 27)


@pytest.mark.parametrize("key,value", [("routed_scaling_factor", 2.5),
                                       ("first_k_dense_replace", 2)])
def test_a_setting_the_port_cannot_express_is_refused(key, value):
    """The port's gate rule has no routed scale (the file's is 1): another
    value, like another fixed key, raises before any weights are drawn."""
    cfg = dict(_published(), **{key: value})
    with pytest.raises(ValueError, match=key):
        registry.family(cfg).port_config(cfg)


class _OldEngine:
    """A ``ServingEngine`` without the settings object (the port before
    it)."""

    def __init__(self, cfg, params, max_batch=8, max_seq=1024, device=None,
                 temperature=0.0, seed=0, paged=False, kv_blocks=None,
                 kv_block_tokens=16, prefix_sharing=True,
                 moe_dispatch="dense", ctx=None):
        raise AssertionError("the engine was built")


def test_a_port_without_the_settings_object_is_refused(monkeypatch):
    from repro_torch.serving import engine
    monkeypatch.setattr(engine, "ServingEngine", _OldEngine)
    cfg = _published()
    fam = registry.family(cfg)
    with pytest.raises(ValueError, match="block settings"):
        fam.engine_args(cfg)
    with pytest.raises(ValueError, match="block settings"):
        fam.port_config(cfg)
    with pytest.raises(ValueError, match="block settings"):
        port.engine(cfg, {}, "cpu")


def test_a_cell_cut_small_runs_correct_on_the_cpu():
    """The route of `test_a_new_block_is_taken_by_files_alone` for this
    family: the cell cut small (`tiny.cell`), weights drawn, the port's
    engine under the traffic, the family's reference judging it."""
    tc = tiny.cell("dsv2lite-docqa")
    assert tc.config["model_type"] == "deepseek_v2"
    seed = 2**31 + 11
    # a window long enough that requests finish in it on a loaded CPU
    out = C.measure(tc, C.Prepared(tc, seed, "cpu", time.perf_counter()),
                    seed=seed, seconds=8.0, trace=False, device="cpu")
    assert out["correct"], out["checks"]
    assert out["checks"]["compared_tokens"]["value"] >= 20
