"""The readers of the engine's own stamps (``admitted_at``, ``first_token_at``)
and ``tools/spans.py``'s reading of the program's ranges, on a synthetic
record and trace; and nothing read where the engine has no such stamps, as
before them."""
import math
import types

import numpy as np
import pytest

from cardbench.core import profile, ranges, registry, serve, traffic
from cardbench.families._decoder import Shape
from cardbench.tools import spans as S

SHAPE = Shape(layers=2, dense_layers=2, d=64, hq=4, hkv=2, hd=16, ff=128,
              vocab=256)
MS = 1_000_000                       # 1 ms in ns
BASE = 100.0                         # perf_counter s at the trace's 0 ns


def _events(twins=True):
    E = profile.Event
    ev = [E("cardbench.step.1", 0, 10 * MS, False),
          E("cardbench.step.2", 10 * MS, 20 * MS, False),
          E("cardbench.step.3", 20 * MS, 40 * MS, False),
          E("cardbench.step.1", 0, 10 * MS, True),
          E("engine.step", 0, 10 * MS, False),
          E("engine.decode", int(1.5 * MS), 5 * MS, False),
          E("engine.sync", 5 * MS, 9 * MS, False),
          E("engine.step", 10 * MS, 20 * MS, False),
          E("engine.step", 20 * MS, 40 * MS, False),
          E("engine.admit", 20 * MS, 32 * MS, False),
          E("engine.prefill", int(20.5 * MS), 31 * MS, False),
          E("model.attn", int(20.8 * MS), 22 * MS, False),
          E("model.head", 29 * MS, int(29.4 * MS), False),
          E("cudaLaunchKernel", 22 * MS, 23 * MS, False),
          E("decode_kernel", 2 * MS, 4 * MS, True),
          E("combine_kernel", 4 * MS, 5 * MS, True),
          E("nvjet_gemm", 12 * MS, 18 * MS, True),
          E("flash_tc_kernel", 21 * MS, 29 * MS, True),
          E("head_gemm", int(29.5 * MS), int(30.5 * MS), True)]
    if twins:
        ev += [E("engine.prefill", 21 * MS, int(30.5 * MS), True),
               E("model.head", int(29.5 * MS), int(30.5 * MS), True),
               E("engine.step", 0, 10 * MS, True)]
    return ev


def _handle(submitted, admitted, first, stamped=True):
    h = types.SimpleNamespace(submitted_at=submitted, first_token_at=first)
    if stamped:
        h.admitted_at = admitted
    return h


def _record(trace=None, stamped=True):
    it = traffic.Item(idx=0, prompt_len=30, max_new=4, deadline=2.0)
    steps = [serve.Step(0, BASE - 0.05, BASE - 0.01, [30], [31]),
             serve.Step(1, BASE, BASE + 0.010, [], [12, 20]),
             serve.Step(2, BASE + 0.010, BASE + 0.020, [], [13, 21]),
             serve.Step(3, BASE + 0.020, BASE + 0.040, [30], [14]),
             ]
    for s in steps[1:]:
        s.traced = trace is not None
    stamps = [(BASE - 0.08, BASE - 0.07, BASE - 0.04, BASE - 0.025),
              (BASE - 0.05, BASE - 0.049, -1.0, -1.0),
              (BASE + 0.01, BASE + 0.015, BASE + 0.0205, BASE + 0.031)]
    reqs = []
    for due, sub, adm, first in stamps:
        r = serve.Served(item=it, prompt=[1] * 30, due=due, submitted=sub)
        r.handle = _handle(sub, adm, first, stamped)
        reqs.append(r)
    return serve.Record(shape=SHAPE, window=(BASE - 0.1, BASE + 0.05),
                        end=BASE + 0.2, steps=steps, requests=reqs,
                        trace=trace)


def _read(name, rec):
    return registry.reader(name)(rec)


def _traced():
    return _record(profile.reduce(_events(twins=False)))


def test_stamp_readers():
    rec = _traced()
    # the prefill begun and ended before the profiler: 40 - 25 ms
    assert _read("prefill_ms.chat", rec) == pytest.approx(15.0)
    assert _read("prefill_ms.docqa", rec) == _read("prefill_ms.chat", rec)
    # due before the profiler: 30 ms admitted, one never admitted (to the
    # run's end, 249 ms)
    assert _read("queue_p95_ms.docqa", rec) == pytest.approx(
        float(np.percentile([30.0, 249.0], 95)))


def test_idle_in_prefill_on_the_trace_clock():
    rec = _traced()
    assert ranges.trace_offset_ns(rec) == pytest.approx(-BASE * 1e9)
    # idle [0,2] [5,12] [18,21] [29,29.5] [30.5,40] ms; the prefill
    # [20.5,31] meets 0.5 + 0.5 + 0.5 of its 22
    assert _read("idle_in_prefill.chat", rec) == pytest.approx(100 * 1.5 / 22)
    assert _read("idle_in_prefill.docqa", rec) == \
        _read("idle_in_prefill.chat", rec)


def test_nothing_without_the_stamps_or_the_trace():
    rec = _record(profile.reduce(_events(twins=False)), stamped=False)
    for name in ("prefill_ms.chat", "queue_p95_ms.docqa",
                 "idle_in_prefill.docqa"):
        assert _read(name, rec) is None
    assert _read("idle_in_prefill.chat", _record()) is None


def test_twins_dropped_the_trace_reads_as_without_them():
    bare = profile.reduce(_events(twins=False))
    kept, twins = S.split_twins(_events())
    assert sorted(t.name for t in twins) == ["engine.prefill", "engine.step",
                                             "model.head"]
    tr = profile.reduce(kept)
    assert tr.busy_s == pytest.approx(bare.busy_s) == pytest.approx(0.018)
    assert tr.breakdown == bare.breakdown
    assert tr.device_ops == bare.device_ops
    # left in, the twins fill the gaps the trace had
    assert profile.reduce(_events()).busy_s > bare.busy_s


def test_idle_and_device_time_by_range():
    events = _events()
    kept, _ = S.split_twins(events)
    launch = {("decode_kernel", 2 * MS, 4 * MS): int(1.6 * MS),
              ("combine_kernel", 4 * MS, 5 * MS): int(1.7 * MS),
              ("nvjet_gemm", 12 * MS, 18 * MS): 11 * MS,
              ("flash_tc_kernel", 21 * MS, 29 * MS): 21 * MS,
              ("head_gemm", int(29.5 * MS), int(30.5 * MS)): int(29.2 * MS)}
    got = S.by_range(events, profile.reduce(kept), launch)
    assert dict(got["idle_by_range"]) == pytest.approx(
        {"engine.step": 0.0145, "engine.sync": 0.007,
         "engine.prefill": 0.0005})
    assert dict(got["device_by_range"]) == pytest.approx(
        {"model.attn": 0.008, "engine.step": 0.006, "engine.decode": 0.003,
         "model.head": 0.001})
    assert got["device_unlinked_s"] == 0
    assert got["idle_in_prefill"] == pytest.approx(100 * 1.5 / 22)
    assert got["device_in_prefill"] == pytest.approx(100 * 9 / 18)
    assert got["head_share"] == pytest.approx(100 / 18)
    del launch[("nvjet_gemm", 12 * MS, 18 * MS)]
    got = S.by_range(events, profile.reduce(kept), launch)
    assert got["device_unlinked_s"] == pytest.approx(0.006)
    assert "engine.step" not in dict(got["device_by_range"])


class _Kineto:
    """A profiler event as ``kineto_results.events()`` yields it."""

    def __init__(self, name, start, dur, cuda, corr=0, linked=0):
        self.args = name, start, dur, cuda, corr, linked

    def name(self):
        return self.args[0]

    def start_ns(self):
        return self.args[1]

    def duration_ns(self):
        return self.args[2]

    def device_type(self):
        return "DeviceType.CUDA" if self.args[3] else "DeviceType.CPU"

    def correlation_id(self):
        return self.args[4]

    def linked_correlation_id(self):
        return self.args[5]


def test_device_operations_link_to_their_launch():
    raw = [_Kineto("aten::mm", 100, 50, False, corr=3),
           _Kineto("cudaLaunchKernel", 110, 5, False, corr=7),
           _Kineto("gemm", 400, 30, True, corr=7, linked=3),
           _Kineto("copy", 500, 10, True, corr=99, linked=3),
           _Kineto("orphan", 600, 10, True, corr=98, linked=97)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: raw)))
    events, launch = S.linked_events(prof)
    assert [(e.name, e.start_ns, e.end_ns, e.on_device) for e in events] == \
        [("aten::mm", 100, 150, False), ("cudaLaunchKernel", 110, 115, False),
         ("gemm", 400, 430, True), ("copy", 500, 510, True),
         ("orphan", 600, 610, True)]
    # the launch call by correlation id first, else the op by linked id
    assert launch == {("gemm", 400, 430): 110, ("copy", 500, 510): 100}


def test_innermost_pieces():
    starts, pieces = ranges.innermost([("a", 0, 10), ("b", 2, 4),
                                       ("c", 3, 4), ("d", 6, 8),
                                       ("e", 12, 14)])
    assert pieces == [(0, 2, "a"), (2, 3, "b"), (3, 4, "c"), (4, 6, "a"),
                      (6, 8, "d"), (8, 10, "a"), (12, 14, "e")]
    assert [ranges.label_at(starts, pieces, t, "-")
            for t in (1, 2.5, 3.5, 5, 7, 9, 11, 13, 15)] == \
        ["a", "b", "c", "a", "d", "a", "-", "e", "-"]


def test_span_readings_over_the_host_window():
    from repro_torch.obs.spans import Span

    def ns(s):
        return int(round(s * 1e9))
    spans = [Span("engine.step", ns(BASE - 0.05), ns(BASE - 0.01)),
             Span("engine.admit", ns(BASE - 0.05), ns(BASE - 0.03), 0),
             Span("engine.prefill", ns(BASE - 0.05), ns(BASE - 0.03), 1,
                  {"rid": 0, "tokens": 40, "bucket": 64}),
             Span("engine.cache", ns(BASE - 0.05), ns(BASE - 0.045), 2),
             Span("engine.sync", ns(BASE - 0.035), ns(BASE - 0.03), 2),
             Span("engine.decode", ns(BASE - 0.03), ns(BASE - 0.02), 0),
             Span("engine.sync", ns(BASE - 0.02), ns(BASE - 0.01), 0),
             Span("engine.step", ns(BASE), ns(BASE + 0.01))]   # traced
    got = S.span_readings(spans, _traced(), {"engine.prefill_positions": 64})
    assert got["prefill_ms"] == pytest.approx(20.0)
    assert got["decode_dispatch_ms"] == pytest.approx(10.0)
    assert got["cache_ms"] == pytest.approx(5.0)
    assert got["insert_ms"] is None
    assert got["host_wait_share"] == pytest.approx(100 * 15 / 40)
    assert got["pad_share"] == pytest.approx(100 * 24 / 64)
    assert (got["steps"], got["spans_per_step"]) == (1, 7.0)
    cost = S.host_costs_us(100)
    assert set(cost) == {"span", "site_off"}
    assert all(v > 0 and not math.isnan(v) for v in cost.values())
