"""The families hold the yardstick where it stood: for Yi-6B and
DeepSeekMoE-16B, at the published widths and at the CPU tests' (``small``),
the weight layout, the small trees drawn from seeds 3 and 5, the
reference's logits, the port's ``ModelConfig``, the engine's arguments and
every work count equal ``golden_families.json``, the values the harness
gave before the block moved into ``families/`` (its ``taken_with`` says
where; the CPU's bfloat16 normals differ between torch versions, so those
trees are kept a version). And the gate rule of the ``deepseek`` family:
the file's ``norm_topk_prob`` reaches an engine that takes one, and a file
that keeps the softmax's gates is refused by one that does not."""
import dataclasses
import hashlib
import json
from pathlib import Path

import pytest
import torch

from cardbench.core import port, reference, registry, weights, work

GOLDEN = json.loads((Path(__file__).with_name("golden_families.json"))
                    .read_text())["cases"]
CASES = sorted(GOLDEN)
SMALL = [c for c in CASES if c.endswith("/small")]


def _published(name):
    return registry.load_json(registry.BENCH_DIR / "configs"
                              / f"{name}.json")


def _cfg(case):
    """The case's configuration; a mixture of experts with the port's gate
    rule (renormalised), which the port runs."""
    name, size = case.split("/")
    cfg = _published(name)
    if size == "small":
        cfg = registry.family(cfg).small(cfg)
    return dict(cfg, norm_topk_prob=True) if "norm_topk_prob" in cfg \
        else cfg


def _shape(cfg):
    return registry.family(cfg).shape(cfg)


def _layout(cfg):
    return [[list(p), list(sh), repr(float(std)), dt]
            for p, sh, std, dt in _shape(cfg).layout()]


def _digest(obj):
    return hashlib.sha256(json.dumps(obj, sort_keys=True).encode()) \
        .hexdigest()


def _plain(x):
    if isinstance(x, (tuple, list)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


@pytest.mark.parametrize("case", CASES)
def test_layout(case):
    g, lay = GOLDEN[case], _layout(_cfg(case))
    assert len(lay) == g["n_leaves"]
    if "layout_leaves" in g:
        assert lay == g["layout_leaves"]
    assert _digest(lay) == g["layout"]


@pytest.mark.parametrize("case", SMALL)
def test_small_cuts_the_same_widths(case):
    pub = _published(case.split("/")[0])
    small = registry.family(pub).small(pub)
    assert set(small) == set(pub)
    assert {k: v for k, v in small.items() if pub[k] != v} == \
        GOLDEN[case]["small_keys"]


@pytest.mark.parametrize("case", CASES)
def test_work_counts(case):
    g, s = GOLDEN[case], _shape(_cfg(case))
    assert (s.body_params, s.head_params, s.kv_bytes_per_token) == \
        (g["body_params"], g["head_params"], g["kv_bytes_per_token"])
    for n, w in g["work"].items():
        n = int(n)
        assert work.prefill_flops(s, n) == w["prefill_flops"], n
        assert work.decode_flops(s, n) == w["decode_flops"], n
        assert list(work.flash_work(s, n)) == w["flash_work"], n
        assert list(work.decode_work(s, [n])) == w["decode_work"], n
    assert list(work.decode_work(s, [int(n) for n in g["work"]])) == \
        g["decode_work_mixed"]


@pytest.mark.parametrize("case", CASES)
def test_port_config(case):
    got = _plain(dataclasses.asdict(port.port_config(_cfg(case))))
    assert got == GOLDEN[case]["port_config"]


class _Engine:
    """Stands in for ``ServingEngine``: keeps the keyword arguments."""
    seen = None

    def __init__(self, cfg, params, **kw):
        type(self).seen = kw


class _EngineWithGates(_Engine):
    """A ``ServingEngine`` that takes the published gate rule."""

    def __init__(self, cfg, params, norm_topk_prob=True, **kw):
        super().__init__(cfg, params, norm_topk_prob=norm_topk_prob, **kw)


@pytest.fixture
def stand_in(monkeypatch):
    from repro_torch.serving import engine

    def use(cls):
        monkeypatch.setattr(engine, "ServingEngine", cls)
        cls.seen = None
        return cls
    return use


@pytest.mark.parametrize("case", CASES)
def test_engine_arguments(case, stand_in):
    cls = stand_in(_Engine)
    port.engine(_cfg(case), {}, "cpu")
    assert cls.seen == GOLDEN[case]["engine_kwargs"]


def _tree_digest(s, tree):
    h = hashlib.sha256()
    for path, *_ in s.layout():
        node = tree
        for k in path:
            node = node[k]
        h.update(node.float().contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("case", SMALL)
def test_small_trees_and_reference_logits(case):
    g, cfg = GOLDEN[case], _cfg(case)
    for key, want in g["trees"].items():
        if isinstance(want, dict):       # bfloat16: by torch version
            assert torch.__version__ in want, (
                f"no {key} tree for torch {torch.__version__}: take it with "
                f"the harness of commit 00b5585")
            want = want[torch.__version__]
        dt, seed = key.split("/")
        s = _shape(dict(cfg, torch_dtype=dt))
        assert _tree_digest(s, weights.make_weights(s, int(seed), "cpu")) \
            == want, key
    c = dict(cfg, torch_dtype="float32")
    w = weights.make_weights(_shape(c), 5, "cpu")
    toks = torch.randint(0, 256, (1, 40),
                         generator=torch.Generator().manual_seed(1))
    for prec in ("f32", "fp8"):
        lg = reference.logits(w, c, [toks[0], toks[0, :17]],
                              [(0, 40), (5, 12)], prec)
        assert hashlib.sha256(b"".join(x.numpy().tobytes() for x in lg)) \
            .hexdigest() == g["logits"][prec], prec
    if "f32_unnormalised_gates" in g["logits"]:
        lg = reference.logits(w, dict(c, norm_topk_prob=False), [toks[0]],
                              [(0, 40)])[0]
        assert hashlib.sha256(lg.numpy().tobytes()).hexdigest() == \
            g["logits"]["f32_unnormalised_gates"]


def test_an_engine_that_takes_the_gate_rule_gets_the_files(stand_in):
    published = _published("deepseek-moe-16b")
    assert published["norm_topk_prob"] is False
    cls = stand_in(_EngineWithGates)
    port.engine(published, {}, "cpu")
    assert cls.seen["norm_topk_prob"] is False
    port.engine(dict(published, norm_topk_prob=True), {}, "cpu")
    assert cls.seen["norm_topk_prob"] is True


def test_a_renormalising_file_passes_nothing(stand_in):
    cfg = dict(_published("deepseek-moe-16b"), norm_topk_prob=True)
    assert registry.family(cfg).engine_args(cfg) == {}   # the port's engine
    cls = stand_in(_Engine)
    port.engine(cfg, {}, "cpu")
    assert "norm_topk_prob" not in cls.seen


def test_an_engine_without_the_gate_rule_refuses_the_published_file(
        stand_in):
    published = _published("deepseek-moe-16b")
    fam = registry.family(published)
    with pytest.raises(ValueError, match="norm_topk_prob"):
        fam.engine_args(published)                       # the port's engine
    stand_in(_Engine)
    with pytest.raises(ValueError, match="norm_topk_prob"):
        port.engine(published, {}, "cpu")


def test_an_unknown_model_type_names_the_families():
    with pytest.raises(KeyError, match="deepseek.*llama"):
        registry.family({"model_type": "no-such-block"})
    with pytest.raises(KeyError):
        registry.family({"model_type": "_decoder"})
