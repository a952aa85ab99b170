"""The yardstick's arithmetic on hand-worked shapes."""
import pytest

from cardbench.core import registry, work


def _shape(name):
    cfg = registry.load_json(registry.BENCH_DIR / "configs" / f"{name}.json")
    return registry.family(cfg).shape(cfg)


def test_shapes_of_the_configurations():
    yi, ds = _shape("yi-6b"), _shape("deepseek-moe-16b")
    assert (yi.layers, yi.dense_layers, yi.hq, yi.hkv, yi.hd) == \
        (32, 32, 32, 4, 128)
    assert (ds.layers, ds.dense_layers, ds.experts, ds.top_k, ds.shared,
            ds.moe_ff, ds.ff) == (28, 1, 64, 6, 2, 1408, 10944)
    # Yi-6B: 6.06e9 parameters with the embedding and the head
    assert yi.body_params == 32 * (2 * 4096 * 4096 + 2 * 4096 * 512
                                   + 3 * 4096 * 11008) == 5_536_481_280
    assert yi.body_params + 2 * yi.head_params == 6_060_769_280
    # DeepSeekMoE-16B: about 2.8e9 active with the embedding and the head
    moe_layer = 2048 * 64 + 3 * 2048 * 1408 * 8
    assert ds.body_params == 28 * 4 * 2048 * 2048 + 3 * 2048 * 10944 \
        + 27 * moe_layer == 2_409_103_360
    assert 2.7e9 < ds.body_params + 2 * ds.head_params < 2.9e9


def test_flash_work_one_causal_2048_prompt():
    s = _shape("yi-6b")
    flops, nbytes = work.flash_work(s, 2048)
    pairs = 2048 * 2049 // 2                          # 2,098,176
    assert flops == pairs * 2 * 2 * 128 * 32 * 32 == 1_100_048_498_688
    assert nbytes == 32 * 2048 * (2 * 32 + 2 * 4) * 128 * 2 == 1_207_959_552
    assert work.bound_s(flops, nbytes) == pytest.approx(flops / 989e12)


def test_decode_work_one_step_of_32_slots():
    s = _shape("yi-6b")
    flops, nbytes = work.decode_work(s, [1000] * 32)
    # each slot's 1000 keys and values of 4 kv-heads, its query and output
    # of 32 heads, 128 wide, bf16, 32 layers
    assert nbytes == 32 * 2 * 128 * (2 * 4 * 32_000 + 2 * 32 * 32) \
        == 2_113_929_216
    assert flops == 4 * 32 * 32 * 128 * 32_000
    assert work.bound_s(flops, nbytes) == pytest.approx(nbytes / 3.35e12)


def test_model_flops_count_the_prompt_not_the_bucket():
    s = _shape("deepseek-moe-16b")
    assert work.prefill_flops(s, 1025) - work.prefill_flops(s, 1024) == \
        2 * s.body_params + s.attn_flops(1025)
    assert work.decode_flops(s, 10) == 2 * s.body_params \
        + 2 * s.head_params + 4 * 28 * 16 * 128 * 10
