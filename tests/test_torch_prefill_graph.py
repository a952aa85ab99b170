"""The serving engine's prefill graphs on the CPU: where the graph path
applies, its counters, and the graph's work (the static batch-1 cache's
reset, the prefill from the static buffer, the slot insert) run eagerly
against the eager path. Capture and replay need the card
(`tests/test_torch_gpu.py`)."""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import init_params
from repro_torch.models.parallel import ParallelContext
from repro_torch.serving import ServingEngine
from repro_torch.serving import engine as E

MAX_SEQ = 64
COUNTERS = ("engine.prefill_graph_captures", "engine.prefill_graph_replays",
            "engine.prefill_eager")
# every family the engine serves: dense, the gemma embedding scale, gemma3's
# rolling window, Mamba-2, MoE, MLA, M-RoPE, RG-LRU
FAMILIES = ["yi-6b", "gemma-2b", "gemma3-12b", "mamba2-2.7b",
            "deepseek-moe-16b", "minicpm3-4b", "qwen2-vl-2b",
            "recurrentgemma-2b"]


def _weights(arch, dtype="float32"):
    cfg = dataclasses.replace(
        get_config(arch).reduced(n_layers=2, d_model=128, vocab_size=512),
        dtype=dtype)
    return cfg, init_params(cfg, seed=0, device="cpu")


def _prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 512, n).tolist() for n in lengths]


def _serve(weights, prompts, max_batch=3, max_new=5, **kw):
    cfg, params = weights
    eng = ServingEngine(cfg, params, max_batch=max_batch, max_seq=MAX_SEQ,
                        device="cpu", **kw)
    reqs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    eng.run_until_idle()
    return eng, [r.generated for r in reqs]


@pytest.fixture
def graph_body_on_cpu(monkeypatch):
    """Every bucket prefill takes the graph path with no capture: each runs
    the graph's work eagerly, as a bucket's first prefill on the card does."""
    monkeypatch.setattr(E, "prefill_graph_applies",
                        lambda device, ctx, prefix_hit: not prefix_hit)
    monkeypatch.setattr(E.ServingEngine, "_capture",
                        lambda self, bucket: None)


@pytest.fixture(scope="module")
def yi():
    return _weights("yi-6b")


def test_cpu_engine_never_captures(yi):
    prompts = _prompts([3, 7, 12, 20, 33, 50, 9])
    eng, _ = _serve(yi, prompts)
    m = eng.metrics
    assert eng._graphs == {} and eng._graph_io is None
    assert m.get("engine.prefill_graph_captures") == 0
    assert m.get("engine.prefill_graph_replays") == 0
    assert m.get("engine.prefill_eager") == eng.n_prefills == len(prompts)


@pytest.mark.parametrize("device,ctx,prefix_hit,graphed", [
    ("cuda", None, False, True),
    ("cuda:1", ParallelContext(), False, True),      # a mesh-less context
    ("cuda", None, True, False),                     # a prefix hit's suffix
    ("cuda", types.SimpleNamespace(mesh=object()), False, False),  # a mesh
    ("cpu", None, False, False),
])
def test_where_the_graph_path_applies(device, ctx, prefix_hit, graphed):
    assert E.prefill_graph_applies(torch.device(device), ctx,
                                   prefix_hit) is graphed


def test_counters_sit_beside_prefill_positions(yi):
    eng, _ = _serve(yi, _prompts([5, 30]))
    counters = eng.metrics.as_dict()["counters"]
    assert "engine.prefill_positions" in counters
    stats = eng.stats()
    for name in COUNTERS:
        assert name in counters and name not in stats


def test_prefix_hits_count_as_eager(yi):
    """A paged engine's prefix hits decode their suffix eagerly: every
    prefill, bucket or hit, counts once in ``engine.prefill_eager``."""
    head = _prompts([32])[0]
    prompts = [head + [7, 8, 9], head + [10, 11], head + [12]]
    eng, _ = _serve(yi, prompts, max_batch=1, paged=True, kv_block_tokens=16)
    assert eng.n_prefix_hits == 2
    assert eng.metrics.get("engine.prefill_eager") == eng.n_prefills == 3


@pytest.mark.parametrize("arch", FAMILIES)
def test_graph_work_equals_the_eager_prefill(arch, graph_body_on_cpu):
    """The graph's work, run eagerly, gives the eager path's tokens and
    leaves the same slot cache, bit for bit, in every family."""
    weights = _weights(arch)
    prompts = _prompts([3, 7, 12, 20, 33, 50, 9], seed=1)
    graphed, got = _serve(weights, prompts)
    assert graphed.metrics.get("engine.prefill_eager") == 0
    assert graphed.metrics.get("engine.prefill_graph_captures") == \
        len(prompts)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(E, "prefill_graph_applies", lambda *a: False)
        eager, want = _serve(weights, prompts)
    assert got == want
    for a, b in zip(graphed.cache, eager.cache, strict=True):
        for key in a:
            assert torch.equal(a[key], b[key]), key


def test_static_cache_reset_holds(yi, graph_body_on_cpu):
    """A long prompt and then a short one in the same slot give the short
    prompt a fresh engine's tokens, and the slot's rows past its bucket
    hold zeros, as after the eager path's fresh cache."""
    long, short = _prompts([60, 5], seed=2)
    eng = ServingEngine(*yi, max_batch=1, max_seq=MAX_SEQ, device="cpu")
    eng.submit(long, max_new_tokens=3)
    eng.run_until_idle()
    assert eng._graph_io.cache[0]["k"][0, 32:60].abs().sum() > 0
    req = eng.submit(short, max_new_tokens=4)
    eng.run_until_idle()
    _, fresh = _serve(yi, [short], max_batch=1, max_new=4)
    assert req.generated == fresh[0]
    # the prefill wrote the 8 bucket (its padding too), decode up to 8
    for layer in eng.cache:
        assert layer["k"][0, :8].any()
        assert not layer["k"][0, 8:].any()
        assert not layer["v"][0, 8:].any()


def test_add_launches_adds_and_takes_back():
    before = ops.kernel_launches()
    counts = {"flash_attention": 3, "decode_attention": 2,
              "decode_attention_lse": 1, "ssd_diag": 4}
    ops.add_launches(counts)
    after = ops.kernel_launches()
    assert {k: after[k] - before[k] for k in after} == \
        {**dict.fromkeys(after, 0), **counts}
    ops.add_launches({k: -v for k, v in counts.items()})
    assert ops.kernel_launches() == before
