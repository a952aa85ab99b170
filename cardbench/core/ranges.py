"""Interval arithmetic over a reduced trace and the engine's own spans and
stamps (``repro_torch.obs.spans``: the span log, and the requests'
``admitted_at`` and ``first_token_at`` on ``time.perf_counter``), for the
readers of the engine's phases and for ``tools/spans.py``. Intervals are
(start, end) pairs on one clock; lists of them are sorted and disjoint
where a function says so."""
from __future__ import annotations

import bisect
import statistics

from cardbench.core.profile import _union as union  # sorted, disjoint

# the program's own ranges (engine phases, parts of the model)
PROGRAM_RANGES = ("engine.", "model.")


def overlap(a: list, b: list) -> float:
    """Length of the intersection of two sorted, disjoint interval lists."""
    i = j = 0
    total = 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_gaps(trace) -> list:
    """The device's idle intervals over the traced steps (ns on the trace's
    clock): the steps' span less the union of the device operations, as
    ``profile.reduce`` reckons ``busy_s``."""
    w0 = min(s for s, _ in trace.steps.values())
    w1 = max(e for _, e in trace.steps.values())
    busy = union((max(s, w0), min(e, w1)) for _, s, e in trace.device_ops)
    edges = [w0] + [x for span in busy for x in span] + [w1]
    return [(a, b) for a, b in zip(edges[0::2], edges[1::2], strict=True)
            if b > a]


def trace_offset_ns(rec):
    """The trace's clock less the harness's (``time.perf_counter``), in ns:
    the median over the traced steps of the step range's start less the
    step's start stamp, which both clocks took around one instant. None
    without a trace."""
    tr = rec.trace
    if tr is None or not tr.steps:
        return None
    t0 = {s.idx: s.t0 for s in rec.steps}
    return statistics.median(start - t0[i] * 1e9
                             for i, (start, _) in tr.steps.items()
                             if i in t0)


def prefill_intervals(rec) -> list | None:
    """(admitted_at, first_token_at) of every request the engine prefilled
    (``perf_counter`` seconds), or None where its requests carry no
    ``admitted_at`` stamp. A resumed request (admitted after its first
    token) is left out."""
    out = []
    for r in rec.requests:
        h = r.handle
        if h is None:
            continue
        a = getattr(h, "admitted_at", None)
        if a is None:
            return None
        if 0 <= a <= h.first_token_at:
            out.append((a, h.first_token_at))
    return out


def innermost(ranges) -> tuple:
    """Nested ranges (name, start, end) flattened into disjoint pieces, each
    named by the innermost range open over it: (starts, pieces) with
    pieces [(start, end, name)] sorted, for `label_at`."""
    pieces, stack = [], []
    t = None
    for name, s, e in sorted(ranges, key=lambda r: (r[1], -r[2])):
        while stack and stack[-1][0] <= s:
            end, inner = stack.pop()
            pieces.append((t, end, inner))
            t = end
        if stack:
            pieces.append((t, s, stack[-1][1]))
        stack.append((e, name))
        t = s
    while stack:
        end, inner = stack.pop()
        pieces.append((t, end, inner))
        t = end
    pieces = [p for p in pieces if p[1] > p[0]]
    return [p[0] for p in pieces], pieces


def label_at(starts: list, pieces: list, t, outside: str) -> str:
    """The name of the piece of `innermost` that holds `t`, or `outside`."""
    k = bisect.bisect_right(starts, t) - 1
    if k >= 0 and t < pieces[k][1]:
        return pieces[k][2]
    return outside
