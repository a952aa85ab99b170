"""The serving engine's span log, counters and request stamps
(`repro_torch.obs.spans`), on a tiny float32 engine: the spans nest as the
engine's phases do, recording changes no token, and with no span log the
engine opens no span and enters no profiler range."""
import dataclasses
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.models import forward, init_params
from repro_torch.obs import spans as SP
from repro_torch.serving import ServingEngine

MAX_SEQ = 64
PARENTS = {"engine.admit": {"engine.step"},
           "engine.prefill": {"engine.admit"},
           "engine.cache": {"engine.prefill"},
           "engine.insert": {"engine.prefill"},
           "engine.decode": {"engine.step"},
           "engine.sync": {"engine.prefill", "engine.step"}}
MODEL_RANGES = ("model.norm", "model.attn", "model.mlp", "model.head")


@pytest.fixture(scope="module")
def weights():
    cfg = dataclasses.replace(
        get_config("yi-6b").reduced(n_layers=2, d_model=128, vocab_size=512),
        dtype="float32")
    return cfg, init_params(cfg, seed=0, device="cpu")


def _prompts(n=7, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, int(rng.integers(3, 40))).tolist()
            for _ in range(n)]


def _serve(weights, log=None, prompts=None, **kw):
    """Serve `prompts` on a 3-slot engine (more requests than slots, several
    buckets) with `log` as its span log; the requests in submit order."""
    cfg, params = weights
    eng = ServingEngine(cfg, params, max_batch=3, max_seq=MAX_SEQ,
                        device="cpu", **kw)
    eng.spans = log
    reqs = [eng.submit(p, max_new_tokens=5) for p in prompts or _prompts()]
    eng.run_until_idle()
    return eng, reqs


@pytest.fixture(scope="module")
def traced(weights):
    log = SP.SpanLog()
    eng, reqs = _serve(weights, log)
    return eng, reqs, log.spans


def _named(log, name):
    return [s for s in log.spans if s.name == name]


def _bucket(n):
    return min(1 << max(n - 1, 1).bit_length(), MAX_SEQ)


def test_spans_nest_as_the_engine_phases(traced):
    eng, reqs, spans = traced
    assert spans and all(s.t1_ns >= s.t0_ns for s in spans)
    for s in spans:
        if s.name == "engine.step":
            assert s.parent == -1
            continue
        p = spans[s.parent]
        assert p.name in PARENTS[s.name], (s.name, p.name)
        assert p.t0_ns <= s.t0_ns <= s.t1_ns <= p.t1_ns
    steps = [s for s in spans if s.name == "engine.step"]
    assert sum(s.attrs["active"] > 0 for s in steps) == eng.n_decode_steps
    prefills = [s for s in spans if s.name == "engine.prefill"]
    assert [s.attrs for s in prefills] == [
        {"rid": r.rid, "tokens": len(r.prompt),
         "bucket": _bucket(len(r.prompt))} for r in reqs]
    kids = {}
    for s in spans:
        kids.setdefault(s.parent, []).append(s.name)
    for i, s in enumerate(spans):
        if s.name == "engine.prefill":
            assert sorted(kids[i]) == ["engine.cache", "engine.insert",
                                       "engine.sync"]


def test_each_sync_lies_inside_a_prefill_or_a_step(traced):
    _, _, spans = traced
    syncs = [s for s in spans if s.name == "engine.sync"]
    assert syncs
    for s in syncs:
        p = spans[s.parent]
        assert p.name in ("engine.prefill", "engine.step")
        assert p.t0_ns <= s.t0_ns and s.t1_ns <= p.t1_ns
    decoding = [i for i, s in enumerate(spans) if s.name == "engine.step"
                and s.attrs["active"]]
    assert {s.parent for s in syncs if spans[s.parent].name == "engine.step"} \
        == set(decoding)


def test_recording_changes_no_token(weights, traced):
    _, on, _ = traced
    _, off = _serve(weights)
    assert [r.generated for r in on] == [r.generated for r in off]
    assert all(len(r.generated) == 5 for r in on)


def test_counters_count_bucket_positions_and_padding(traced):
    eng, reqs, _ = traced
    lens = [len(r.prompt) for r in reqs]
    assert eng.metrics.get("engine.prefill_positions") == \
        sum(_bucket(n) for n in lens)
    assert eng.metrics.get("engine.prefill_pad_positions") == \
        sum(_bucket(n) - n for n in lens)
    assert "engine.prefill_positions" not in eng.stats()


def test_request_stamps_are_ordered_on_perf_counter(weights):
    t0 = time.perf_counter()
    _, reqs = _serve(weights)
    t1 = time.perf_counter()
    for r in reqs:
        assert t0 <= r.submitted_at <= r.admitted_at <= r.first_token_at \
            <= r.done_at <= t1


def test_without_a_span_log_no_span_opens_and_no_range_is_entered(
        weights, traced, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a span or range was opened")
    monkeypatch.setattr(SP, "record_function", refuse)
    monkeypatch.setattr(SP, "Span", refuse)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, reqs = _serve(weights)
    assert [r.generated for r in reqs] == [r.generated for r in traced[1]]
    names = {e.name for e in prof.events()}
    assert not {n for n in names if n.startswith(("engine.", "model."))}


def test_ranges_show_under_the_profiler(weights):
    log = SP.SpanLog()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(weights, log, prompts=_prompts(3))
    names = {e.name for e in prof.events()}
    assert {s.name for s in log.spans} == set(PARENTS) | {"engine.step"}
    assert {s.name for s in log.spans} | set(MODEL_RANGES) <= names


def test_model_ranges_only_inside_a_recorded_engine_step(weights):
    cfg, params = weights
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        forward(params, {"tokens": torch.zeros(1, 8, dtype=torch.long)},
                cfg=cfg)
    assert not {e.name for e in prof.events()} & set(MODEL_RANGES)


def test_prefix_hit_and_resume_spans(weights):
    """A prefix hit prefills under `engine.prefill` with bucket 0 and adds
    no bucket positions; a resumed request is stamped again at its resume
    and is not prefilled."""
    shared = list(range(100, 132))          # 2 full blocks of 16
    log = SP.SpanLog()
    cfg, params = weights
    eng = ServingEngine(cfg, params, max_batch=2, max_seq=MAX_SEQ,
                        device="cpu", paged=True, kv_block_tokens=16)
    eng.spans = log
    eng.submit(shared + [7, 8, 9], max_new_tokens=3)
    eng.run_until_idle()
    positions = eng.metrics.get("engine.prefill_positions")
    hit = eng.submit(shared + [200, 201], max_new_tokens=6)
    eng.step()
    assert eng.n_prefix_hits == 1
    assert _named(log, "engine.prefill")[-1].attrs == \
        {"rid": hit.rid, "tokens": 34, "bucket": 0}
    assert eng.metrics.get("engine.prefill_positions") == positions
    first = hit.admitted_at
    eng.evict(hit.slot)
    eng.resubmit(hit)
    n_prefills = len(_named(log, "engine.prefill"))
    eng.run_until_idle()
    assert hit.done and hit.admitted_at > first
    assert len(_named(log, "engine.prefill")) == n_prefills
