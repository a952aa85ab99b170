"""The benchmark's weights and reference against the port, at a small size
on the CPU: the weights have the port's parameter tree, and the reference
computes the port's model (a float32 forward of the same weights)."""
import pytest
import torch

from cardbench.core import port, reference, registry, weights
from cardbench.tests import tiny

# (cell, configuration file): the dense cell, and a mixture of experts on
# the DeepSeekMoE file (no cell yet: the port renormalises the top-k gates)
CASES = [("yi6b-chat", None), ("yi6b-docqa", "deepseek-moe-16b")]


def _tree_shapes(tree, prefix=()):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _tree_shapes(v, prefix + (k,)).items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _tree_shapes(v, prefix + (i,)).items()}
    return {prefix: (tuple(tree.shape), tree.dtype)}


@pytest.mark.parametrize("name,config", CASES)
def test_weights_have_the_ports_tree(name, config):
    from repro_torch.models.model import params_shapes
    cfg = tiny.cell(name, config=config).config
    ours = weights.make_weights(registry.family(cfg).shape(cfg), 3, "cpu")
    assert _tree_shapes(ours) == _tree_shapes(
        params_shapes(port.port_config(cfg)))


@pytest.mark.parametrize("name,config", CASES)
def test_reference_computes_the_ports_model(name, config):
    from repro_torch.models.model import forward
    cfg = tiny.cell(name, dtype="float32", config=config).config
    w = weights.make_weights(registry.family(cfg).shape(cfg), 5, "cpu")
    toks = torch.randint(0, 256, (1, 40), generator=torch.Generator()
                         .manual_seed(1))
    want, _ = forward(w, {"tokens": toks}, cfg=port.port_config(cfg),
                      mode="train")
    got = reference.logits(w, cfg, [toks[0]], [(0, 40)])[0]
    torch.testing.assert_close(got, want[0], rtol=1e-4, atol=1e-4)


def test_fp8_control_rounds_to_e4m3():
    x = torch.tensor([[1.0, 0.3, -0.07, 448.0]])
    y = reference._fp8(x, -1)
    assert y[0, 3] == 448.0 and y[0, 0] == 1.0
    assert 0 < abs(y[0, 1] - 0.3) <= 0.3 / 16


def test_published_deepseek_gates_are_not_the_ports():
    """DeepSeekMoE-16B keeps its top-6 gates unnormalised; the port
    renormalises them and cannot be told otherwise, so the harness refuses
    the published file, and the reference under the published rule is
    another model than the port's."""
    from repro_torch.models.model import forward
    published = registry.load_json(registry.BENCH_DIR / "configs"
                                   / "deepseek-moe-16b.json")
    assert published["norm_topk_prob"] is False
    with pytest.raises(ValueError, match="norm_topk_prob"):
        port.port_config(published)
    cfg = tiny.cell("yi6b-docqa", dtype="float32",
                    config="deepseek-moe-16b").config
    w = weights.make_weights(registry.family(cfg).shape(cfg), 5, "cpu")
    toks = torch.randint(0, 256, (1, 40), generator=torch.Generator()
                         .manual_seed(1))
    port_logits, _ = forward(w, {"tokens": toks}, cfg=port.port_config(cfg),
                             mode="train")
    plain = reference.logits(w, dict(cfg, norm_topk_prob=False),
                             [toks[0]], [(0, 40)])[0]
    assert (plain - port_logits[0]).abs().max() > 1e-2
