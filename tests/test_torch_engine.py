"""The port's serving engine against the JAX engine on identical weights:
greedy tokens, slot reuse, EOS, stats keys and the shape counters."""
import jax  # noqa: F401  (both packages in one process)
import numpy as np
import pytest
import torch

from _torch_parity import config_pair, weights_pair
from repro.serving import ServingEngine as JaxEngine
from repro_torch.serving import ServingEngine, sample_tokens


def _engines(arch="gemma-2b", max_batch=3, max_seq=128, **reduced):
    reduced = reduced or dict(n_layers=2, d_model=128, vocab_size=512)
    jcfg, tcfg = config_pair(arch, **reduced)
    jp, tp = weights_pair(jcfg, tcfg)
    return (JaxEngine(jcfg, jp, max_batch=max_batch, max_seq=max_seq),
            ServingEngine(tcfg, tp, max_batch=max_batch, max_seq=max_seq,
                          device="cpu"))


def _prompts(n, vocab, lo=3, hi=40, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(lo, hi))).tolist()
            for _ in range(n)]


@pytest.mark.parametrize("arch,reduced,max_seq", [
    ("gemma-2b", dict(n_layers=2, d_model=128, vocab_size=512), 128),
    ("gemma3-12b", dict(n_layers=2, d_model=128, vocab_size=512), 128),
    ("yi-6b", dict(n_layers=2, d_model=128, vocab_size=512), 64),
])
def test_greedy_tokens_match_jax_engine(arch, reduced, max_seq):
    """More requests than slots, ragged prompt lengths (several pow-2
    buckets) and per-slot positions: the same greedy tokens per request."""
    je, te = _engines(arch, max_batch=3, max_seq=max_seq, **reduced)
    for p in _prompts(7, reduced["vocab_size"], hi=min(40, max_seq - 8)):
        je.submit(p, max_new_tokens=6)
        te.submit(p, max_new_tokens=6)
    jd = sorted(je.run_until_idle(), key=lambda r: r.rid)
    td = sorted(te.run_until_idle(), key=lambda r: r.rid)
    assert [r.generated for r in td] == [r.generated for r in jd]
    assert [r.slot for r in td] == [r.slot for r in jd]
    assert all(len(r.generated) == 6 for r in td)


def test_rolling_window_engine_matches_jax_engine():
    """gemma3-12b's local layers keep 64 rolling slots: prompts longer than
    the window (prefill keeps the last 64) and decoding past it give the
    JAX engine's greedy tokens."""
    je, te = _engines("gemma3-12b", max_batch=3, max_seq=128)
    assert te.cfg.sliding_window == 64
    for n in (45, 52, 60, 70):
        p = [(3 * n + j) % 512 for j in range(n)]
        je.submit(p, max_new_tokens=24)
        te.submit(p, max_new_tokens=24)
    jd = sorted(je.run_until_idle(), key=lambda r: r.rid)
    td = sorted(te.run_until_idle(), key=lambda r: r.rid)
    assert [r.generated for r in td] == [r.generated for r in jd]
    assert all(len(r.generated) == 24 for r in td)


def test_slot_reuse():
    _, te = _engines(max_batch=2, max_seq=64)
    for i in range(5):
        te.submit([1, 2, 3, 4 + i], max_new_tokens=3)
    done = te.run_until_idle()
    assert len(done) == 5
    assert {r.slot for r in done} <= {0, 1}
    assert te.active_slots == [] and te.queue == []


def test_eos_stops_generation_as_in_jax():
    je, te = _engines(max_batch=1, max_seq=64)
    r0 = te.submit([5, 6, 7], max_new_tokens=4)
    te.run_until_idle()
    eos = r0.generated[1]
    _, te2 = _engines(max_batch=1, max_seq=64)
    r = te2.submit([5, 6, 7], max_new_tokens=10, eos_id=eos)
    je.submit([5, 6, 7], max_new_tokens=10, eos_id=eos)
    te2.run_until_idle()
    (jr,) = je.run_until_idle()
    assert r.generated == r0.generated[:2] == jr.generated


def test_max_seq_finishes_a_request():
    je, te = _engines(max_batch=1, max_seq=16)
    je.submit(list(range(1, 11)), max_new_tokens=50)
    r = te.submit(list(range(1, 11)), max_new_tokens=50)
    te.run_until_idle()
    (jr,) = je.run_until_idle()
    assert r.done and r.generated == jr.generated
    assert len(r.generated) == 16 - 1 - 10 + 1


def test_stats_keys_match_jax_engine():
    je, te = _engines()
    for e in (je, te):
        e.submit([1, 2, 3], max_new_tokens=2)
        e.run_until_idle()
    assert te.stats() == je.stats()
    assert te.stats()["n_served"] == 1 and te.stats()["n_prefills"] == 1


def test_compile_counters_follow_jax_engine():
    """decode counts one (batch, 1) shape, prefill one per pow-2 bucket."""
    je, te = _engines(max_batch=2, max_seq=64)
    assert te.decode_compiles == 0 and te.prefill_compiles == 0
    for batch in ([[1, 2, 3, 4, 5], [9, 8, 7, 6, 5, 4, 3]],   # bucket 8
                  [list(range(1, 21))],                         # bucket 32
                  [[2, 4, 6], [3, 5, 7]]):                      # bucket 4
        for e in (je, te):
            for p in batch:
                e.submit(p, max_new_tokens=3)
            e.run_until_idle()
        assert (te.prefill_compiles, te.decode_compiles) \
            == (je.prefill_compiles, je.decode_compiles)
    assert (te.prefill_compiles, te.decode_compiles) == (3, 1)


def test_evict_frees_the_slot():
    _, te = _engines(max_batch=2, max_seq=64)
    te.submit([1, 2, 3], max_new_tokens=8)
    te.step()
    (slot,) = te.active_slots
    req = te.evict(slot)
    assert req is not None and not req.done and req.slot == -1
    assert te.active_slots == [] and te.evict(slot) is None
    te.submit(req.prompt, max_new_tokens=2)
    assert len(te.run_until_idle()) == 1


def test_freq_scale_and_paged_not_ported():
    _, te = _engines()
    te.set_freq_scale(0.5)
    assert te.freq_scale == 0.5
    with pytest.raises(ValueError):
        te.set_freq_scale(0.0)
    assert te.paged is False and te.kv is None
    _, tcfg = config_pair("gemma-2b", n_layers=2, d_model=128, vocab_size=512)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServingEngine(tcfg, te.params, device="cpu", paged=True)


def test_sampling_modes():
    logits = torch.tensor([[0.0, 5.0, 0.0, 0.0]])
    gen = torch.Generator().manual_seed(0)
    assert int(sample_tokens(logits, 0.0)[0]) == 1
    # top-k=1 == greedy even with temperature
    assert int(sample_tokens(logits, 1.0, top_k=1, generator=gen)[0]) == 1
    draws = {int(sample_tokens(logits, 50.0, generator=gen)[0])
             for _ in range(40)}
    assert len(draws) > 1
    # the same seed gives the same draws
    a = sample_tokens(logits.repeat(16, 1), 50.0,
                      generator=torch.Generator().manual_seed(7))
    b = sample_tokens(logits.repeat(16, 1), 50.0,
                      generator=torch.Generator().manual_seed(7))
    assert torch.equal(a, b) and a.dtype == torch.int32
