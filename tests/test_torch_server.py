"""The port's PerLLM fleet against the JAX fleet: the same scheduler over
engines with the same weights makes the same routing decisions and
generates the same tokens (float32 configs, greedy decoding). The live
server's preemption of an engine slot (dense and paged) and its DVFS tier
pacing, the bodies of `tests/test_admission.py` and
`tests/test_allocation.py`, give the JAX server's stats field for field."""
import dataclasses

import jax
import numpy as np
import pytest

from _torch_parity import config_pair, numpy_tree
import repro.core as jax_core
import repro_torch.core as torch_core
from repro.cluster import paper_testbed as jax_testbed
from repro.models import init_params as jax_init_params
from repro.serving import ServingEngine as JaxEngine
from repro.serving.perllm_server import PerLLMServer as JaxServer
from repro_torch.cluster import paper_testbed
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import ServingEngine
from repro_torch.serving.perllm_server import PerLLMServer


def _fleets(**kw):
    """The fleet of tests/test_perllm_server.py in both packages."""
    key = jax.random.key(0)
    edge = config_pair("gemma-2b", n_layers=2, d_model=64, vocab_size=256)
    cloud = config_pair("gemma3-12b", n_layers=2, d_model=128,
                        vocab_size=256)
    shapes = [(edge, 2, 64), (edge, 2, 64), (cloud, 4, 64)]
    jax_engines, torch_engines = [], []
    for (jcfg, tcfg), max_batch, max_seq in shapes:
        jp = jax_init_params(key, jcfg)
        tp = params_from_jax(numpy_tree(jp), tcfg, device="cpu")
        jax_engines.append(JaxEngine(jcfg, jp, max_batch=max_batch,
                                     max_seq=max_seq))
        torch_engines.append(ServingEngine(tcfg, tp, max_batch=max_batch,
                                           max_seq=max_seq, device="cpu"))
    jspecs = jax_testbed(n_edge=2)[:2] + [jax_testbed()[-1]]
    tspecs = paper_testbed(n_edge=2)[:2] + [paper_testbed()[-1]]
    return (JaxServer(jspecs, jax_engines, **kw),
            PerLLMServer(tspecs, torch_engines, **kw))


def _submit_same(servers, n, seed=0, deadline=4.0, max_new=3):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        prompt = rng.integers(0, 256, int(rng.integers(4, 16))).tolist()
        for srv in servers:
            srv.submit(prompt, max_new_tokens=max_new, deadline=deadline)


@pytest.mark.parametrize("n,deadline", [(10, 4.0), (16, 1.0)])
def test_fleet_matches_jax_fleet(n, deadline):
    js, ts = _fleets()
    _submit_same((js, ts), n, deadline=deadline)
    jd = {sr.service.sid: sr for sr in js.run_until_idle()}
    td = {sr.service.sid: sr for sr in ts.run_until_idle()}
    assert jd.keys() == td.keys() and len(td) == n
    for sid, tsr in td.items():
        jsr = jd[sid]
        assert tsr.server == jsr.server, sid
        assert tsr.engine_req.generated == jsr.engine_req.generated, sid
        assert tsr.done_clock == pytest.approx(jsr.done_clock)
    assert ts.stats["per_server"] == js.stats["per_server"]
    assert ts.stats["served"] == js.stats["served"] == n
    assert ts.stats["deadline_met"] == pytest.approx(js.stats["deadline_met"])


def test_fleet_learner_and_trace_match_jax():
    from repro.obs import TraceRecorder as JaxRecorder
    from repro_torch.obs import KIND_ARM, TraceRecorder
    jrec, trec = JaxRecorder(), TraceRecorder()
    js, _ = _fleets(trace=jrec)
    _, ts = _fleets(trace=trec)
    _submit_same((js, ts), 6, seed=1)
    js.run_until_idle()
    ts.run_until_idle()
    assert int(ts.scheduler.bandit.count.sum()) == 6
    np.testing.assert_array_equal(ts.scheduler.bandit.count,
                                  js.scheduler.bandit.count)
    jcols, tcols = jrec.to_arrays(), trec.to_arrays()
    np.testing.assert_array_equal(tcols["kind"], jcols["kind"])
    np.testing.assert_array_equal(tcols["sid"], jcols["sid"])
    assert int((tcols["kind"] == KIND_ARM).sum()) == 6


def _live_pair(engine_kw, spec_fn, policy_fn, max_batch, max_seq):
    """A one-engine live server in each package on the same weights:
    reduced float32 gemma-2b (1 layer, d_model 32, vocab 128), the spec
    `spec_fn(paper_testbed)` and the policy `policy_fn(core)`."""
    jcfg, tcfg = config_pair("gemma-2b", n_layers=1, d_model=32,
                             vocab_size=128)
    jp = jax_init_params(jax.random.key(0), jcfg)
    tp = params_from_jax(numpy_tree(jp), tcfg, device="cpu")
    jeng = JaxEngine(jcfg, jp, max_batch=max_batch, max_seq=max_seq,
                     **engine_kw)
    teng = ServingEngine(tcfg, tp, max_batch=max_batch, max_seq=max_seq,
                         device="cpu", **engine_kw)
    jpol, tpol = policy_fn(jax_core), policy_fn(torch_core)
    return ((JaxServer([spec_fn(jax_testbed)], [jeng], scheduler=jpol), jpol),
            (PerLLMServer([spec_fn(paper_testbed)], [teng], scheduler=tpol),
             tpol))


def _same_stats(js, ts):
    jst, tst = js.stats, ts.stats
    assert tst.keys() == jst.keys()
    for k, v in jst.items():
        assert tst[k] == pytest.approx(v), k


def _preempt_latest(core):
    class PreemptLatest(core.SchedulingPolicy):
        name = "preempt-latest"

        def __init__(self):
            self.armed = False

        def assign(self, req, view):
            victim = None
            if self.armed and view.running and view.running[0]:
                victim = view.running[0][0].sid
            return core.Decision(server=0, preempt_victim=victim)
    return PreemptLatest()


def _one_lane(testbed):
    return dataclasses.replace(testbed(n_edge=1)[0], name="edge0",
                               bandwidth=100e6, max_concurrency=1)


@pytest.mark.parametrize("engine_kw", [{}, {"paged": True, "kv_blocks": 8}],
                         ids=["dense", "paged"])
def test_live_server_preempts_engine_slot_as_jax(engine_kw):
    """The body of test_admission.py's live preemption on both servers: the
    victim leaves its engine slot with its remaining tokens requeued, both
    requests finish, and every stats field and token list agrees."""
    (js, jpol), (ts, tpol) = _live_pair(engine_kw, _one_lane,
                                        _preempt_latest, 1, 64)
    out = []
    for srv, pol in ((js, jpol), (ts, tpol)):
        first = srv.submit([1, 2, 3], max_new_tokens=12, payload_bytes=1e4)
        for _ in range(60):
            if srv.engines[0].active_slots:
                break
            srv.step()
        assert srv.engines[0].active_slots
        pol.armed = True
        second = srv.submit([4, 5], max_new_tokens=2, payload_bytes=1e4)
        done = srv.run_until_idle()
        assert srv.n_preempted == 1 and first.service.preemptions == 1
        assert first.service.output_tokens < 12
        assert {sr.service.sid for sr in done} \
            == {first.service.sid, second.service.sid}
        assert not srv.rejected
        out.append({sr.service.sid: (sr.engine_req.generated, sr.done_clock)
                    for sr in done})
    assert out[1].keys() == out[0].keys()
    for sid, (toks, clock) in out[1].items():
        assert toks == out[0][sid][0]
        assert clock == pytest.approx(out[0][sid][1])
    _same_stats(js, ts)


def _pin_slow(core):
    class PinSlow(core.SchedulingPolicy):
        name = "pin-slow"

        def assign(self, req, view):
            return core.Decision(server=0,
                                 alloc=core.Allocation(freq_tier=0))
    return PinSlow()


def test_live_server_tier_paces_engine_ticks_as_jax():
    """The body of test_allocation.py's DVFS tier pacing on both servers:
    the engine runs at freq_scale 0.5, each tick costs twice the analytic
    step, the energy is f^3 power over the stretched window, and every
    stats field agrees."""
    def slow_spec(testbed):
        return dataclasses.replace(testbed(n_edge=1)[0],
                                   freq_tiers=(0.5, 1.0))
    (js, _), (ts, _) = _live_pair({}, slow_spec, _pin_slow, 2, 32)
    reqs = []
    for srv in (js, ts):
        sr = srv.submit([1, 2, 3], max_new_tokens=4, payload_bytes=1e4)
        assert sr in srv.run_until_idle()
        assert srv.engines[0].freq_scale == 0.5 and srv.engine_tier[0] == 0
        spec = srv.specs[0]
        assert spec.decode_step_time(tier=0) \
            == pytest.approx(2.0 * spec.decode_step_time())
        window = sr.done_clock - sr.admit_clock
        assert spec.infer_energy(window, tier=0) \
            == pytest.approx(spec.infer_energy(window) * 0.125)
        reqs.append(sr)
    assert reqs[1].engine_req.generated == reqs[0].engine_req.generated
    assert reqs[1].done_clock - reqs[1].admit_clock \
        == pytest.approx(reqs[0].done_clock - reqs[0].admit_clock)
    _same_stats(js, ts)
