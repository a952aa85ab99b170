"""Every metric reader on a synthetic record and trace."""
import math

import numpy as np
import pytest

from cardbench.core import profile, registry, serve, traffic, work
from cardbench.families._decoder import Shape

SHAPE = Shape(layers=2, dense_layers=2, d=64, hq=4, hkv=2, hd=16, ff=128,
              vocab=256)


def _req(due, stamps, max_new, deadline=2.0, plen=10):
    it = traffic.Item(idx=0, prompt_len=plen, max_new=max_new,
                      deadline=deadline)
    r = serve.Served(item=it, prompt=[1] * plen, due=due, submitted=due)
    r.stamps = list(stamps)
    r.done = stamps[-1] if len(stamps) == max_new else math.nan
    return r


def _record(trace=None):
    steps = [serve.Step(0, 10.0, 10.5, [10], [11]),      # prefill + decode
             serve.Step(1, 10.5, 10.6, [], [12, 20]),
             serve.Step(2, 10.6, 10.7, [], [13, 21]),
             serve.Step(3, 10.7, 11.0, [30], [14, 31])]
    reqs = [_req(9.9, [10.5, 10.5, 10.6, 10.7], 4),       # met, in window
            _req(10.2, [10.6, 11.0], 4),                   # unfinished
            _req(8.0, [9.0, 10.6, 10.7], 3, deadline=1.0)]  # due before
    rec = serve.Record(shape=SHAPE, window=(10.0, 11.0),
                       end=12.0, steps=steps, requests=reqs, setup_s=3.5,
                       energy_j=50.0, trace=trace)
    return rec


def _read(name, rec):
    return registry.reader(name)(rec)


def test_end_to_end_readers():
    rec = _record()
    # tokens stamped in (10, 11]: 4 + 2 + 2
    assert _read("out_tok_s.chat", rec) == pytest.approx(8.0)
    assert _read("setup_s", rec) == 3.5
    # due in [10, 11): only the second request, first token at 10.6
    assert _read("ttft_p95_ms", rec) == pytest.approx(400.0)
    assert _read("deadline_met", rec) == 0.0
    # completed in the window: the first (10.7) and the third (10.7)
    assert _read("j_per_req.docqa", rec) == pytest.approx(25.0)


def test_host_span_readers():
    rec = _record()
    assert _read("decode_step_ms.docqa", rec) == pytest.approx(100.0)
    assert _read("step_ms.chat", rec) == pytest.approx(200.0)
    gaps = [0.0, 100, 100, 400, 1600, 100]   # later token in the window
    assert _read("itl_p95_ms.docqa", rec) == pytest.approx(
        float(np.percentile(gaps, 95)))
    flops = (work.prefill_flops(SHAPE, 10) + work.prefill_flops(SHAPE, 30)
             + sum(work.decode_flops(SHAPE, k)
                   for k in (11, 12, 20, 13, 21, 14, 31)))
    assert _read("mfu.chat", rec) == pytest.approx(100 * flops / 989e12)
    assert _read("mfu.docqa", rec) == _read("mfu.chat", rec)


def _events():
    E = profile.Event
    ns = 1_000_000                     # 1 ms
    ev = [E("cardbench.step.1", 0, 10 * ns, False),
          E("cardbench.step.2", 10 * ns, 20 * ns, False),
          E("cardbench.step.3", 20 * ns, 40 * ns, False),
          E("cardbench.step.1", 0, 10 * ns, True),     # device-side span
          E("aten::mm", 0, 9 * ns, False),
          E("cudaLaunchKernel", 1 * ns, 2 * ns, False),
          E("cuLaunchKernelEx", 3 * ns, 4 * ns, False),
          E("cudaLaunchKernel", 12 * ns, 13 * ns, False),
          E("cudaLaunchKernel", 22 * ns, 23 * ns, False),
          E("aten::copy_", 30 * ns, 39 * ns, False),
          E("void repro::(anonymous namespace)::tc::decode_tc_kernel<8>",
            2 * ns, 4 * ns, True),
          E("void repro::splitkv::combine_kernel<bf16>", 4 * ns, 5 * ns,
            True),
          E("nvjet_gemm", 12 * ns, 18 * ns, True),
          E("void repro::(anonymous namespace)::tc::flash_tc_kernel<128,2>",
            21 * ns, 29 * ns, True)]
    return ev


def test_trace_reduction():
    tr = profile.reduce(_events())
    assert tr.window_s == pytest.approx(0.040)
    assert tr.busy_s == pytest.approx(0.017)
    assert tr.launches == {1: 2, 2: 1, 3: 1}
    assert tr.device_seconds(r"repro::.*(decode|combine)") == \
        pytest.approx(0.003)
    gaps = dict(tr.breakdown["idle_gaps"])
    assert gaps == pytest.approx({"cudaLaunchKernel": 0.002, "aten::mm": 0.007,
                                  "python (no aten op or CUDA call)": 0.003,
                                  "aten::copy_": 0.011})
    assert sum(gaps.values()) == pytest.approx(0.023)
    assert [n for n, _ in tr.breakdown["device_ops"]][:2] == [
        "void repro::(anonymous namespace)::tc::flash_tc_kernel<128,2>",
        "nvjet_gemm"]


def test_trace_readers():
    rec = _record(profile.reduce(_events()))
    assert _read("idle_share.chat", rec) == pytest.approx(100 * 23 / 40)
    assert _read("idle_share.docqa", rec) == _read("idle_share.chat", rec)
    # pure decode steps traced: 1 and 2 (step 3 prefilled): 2 and 1
    assert _read("launches_per_decode_step.docqa", rec) == pytest.approx(1.5)
    # every traced step (1, 2 and 3): 4 launches over 3 steps
    assert _read("launches_per_step.chat", rec) == pytest.approx(4 / 3)
    keys = [[12, 20], [13, 21], [14, 31]]
    least = sum(work.bound_s(*work.decode_work(SHAPE, k)) for k in keys)
    assert _read("decode_roofline.chat", rec) == pytest.approx(
        100 * least / 0.003)
    assert _read("flash_roofline.docqa", rec) == pytest.approx(
        100 * work.bound_s(*work.flash_work(SHAPE, 30)) / 0.008)


def test_readers_without_a_trace_give_nothing():
    rec = _record()
    for name in ("idle_share.chat", "launches_per_decode_step.docqa",
                 "launches_per_step.chat",
                 "decode_roofline.chat", "flash_roofline.docqa"):
        assert _read(name, rec) is None
