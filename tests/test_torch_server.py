"""The port's PerLLM fleet against the JAX fleet: the same scheduler over
engines with the same weights makes the same routing decisions and
generates the same tokens (float32 configs, greedy decoding)."""
import jax
import numpy as np
import pytest

from _torch_parity import config_pair, numpy_tree
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
