"""The device trace of a traced run, reduced in memory: no trace file is
written.

``torch.profiler`` records host operations and the card's activity over the
last seconds of the window; the harness wraps each engine step in a
``record_function`` range named ``cardbench.step.<n>``. The reduction keeps
each device operation's name and span, the host's kernel-launch calls a
step, the device's busy time over the traced span (the union of its
operations' spans), and the longest device idle gaps labelled by the host
operation running at their middle.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import re

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
                "cudaGraphLaunch")
_STEP_RE = re.compile(r"^cardbench\.step\.(\d+)$")


@dataclasses.dataclass
class Event:
    name: str
    start_ns: int
    end_ns: int
    on_device: bool


@dataclasses.dataclass
class Trace:
    """A reduced trace: what the per-layer readers take."""
    device_ops: list            # [(name, start_ns, end_ns)] in start order
    steps: dict                 # step index -> (start_ns, end_ns)
    launches: dict              # step index -> host launch calls inside it
    window_s: float
    busy_s: float
    breakdown: dict

    def device_seconds(self, pattern: str) -> float:
        """Device seconds of the operations whose name matches `pattern`
        (a regular expression), or 0."""
        rx = re.compile(pattern)
        return sum(e - s for n, s, e in self.device_ops if rx.search(n)) / 1e9


def kineto_events(prof) -> list:
    """The profiler's raw events as `Event`s (no per-event Python parse of
    the profiler's own)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = str(e.device_type()).endswith("CUDA")
        start = e.start_ns()
        out.append(Event(e.name(), start, start + e.duration_ns(), dev))
    return out


def _union(spans: list) -> list:
    merged = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce(events: list, top: int = 10) -> Trace:
    steps = {}
    host = []
    device = []
    for ev in events:
        m = _STEP_RE.match(ev.name)
        if m:
            if not ev.on_device:
                steps[int(m.group(1))] = (ev.start_ns, ev.end_ns)
            continue
        (device if ev.on_device else host).append(ev)
    if not steps:
        raise RuntimeError("the trace holds no step range")
    w0 = min(s for s, _ in steps.values())
    w1 = max(e for _, e in steps.values())
    device = sorted((e for e in device if e.end_ns > w0 and e.start_ns < w1),
                    key=lambda e: e.start_ns)
    busy = _union([(max(e.start_ns, w0), min(e.end_ns, w1)) for e in device])
    busy_ns = sum(e - s for s, e in busy)

    order = sorted(steps)
    starts = [steps[i][0] for i in order]
    launches = collections.Counter()
    for ev in host:
        if ev.name in LAUNCH_CALLS:
            k = bisect.bisect_right(starts, ev.start_ns) - 1
            if k >= 0 and ev.start_ns <= steps[order[k]][1]:
                launches[order[k]] += 1

    by_name = collections.Counter()
    for e in device:
        by_name[e.name[:160]] += e.end_ns - e.start_ns
    gaps = collections.Counter()
    host.sort(key=lambda e: e.start_ns)
    hstarts = [e.start_ns for e in host]
    edges = [w0] + [x for span in busy for x in span] + [w1]
    for a, b in zip(edges[0::2], edges[1::2], strict=True):
        if b > a:
            gaps[_host_at(host, hstarts, (a + b) // 2)] += b - a
    breakdown = {
        "device_ops": [[n, t / 1e9] for n, t in by_name.most_common(top)],
        "idle_gaps": [[n, t / 1e9] for n, t in gaps.most_common(top)],
    }
    return Trace(device_ops=[(e.name, e.start_ns, e.end_ns) for e in device],
                 steps=steps, launches=dict(launches),
                 window_s=(w1 - w0) / 1e9, busy_s=busy_ns / 1e9,
                 breakdown=breakdown)


def _host_at(host: list, starts: list, t: int, look: int = 64) -> str:
    """The innermost host operation running at `t`: of those that started
    last before it, the first that has not ended."""
    k = bisect.bisect_right(starts, t) - 1
    for j in range(k, max(k - look, -1), -1):
        if host[j].end_ns >= t:
            return host[j].name[:160]
    return "python (no aten op or CUDA call)"
