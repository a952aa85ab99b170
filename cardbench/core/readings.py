"""Arithmetic the metric readers share (``metrics/<name>.py`` each call
one of these with their own arguments)."""
from __future__ import annotations

import statistics

import numpy as np

from cardbench.core import work

# the program's kernels in the device trace, by name
DECODE_KERNELS = r"repro::.*(decode|combine)"
FLASH_KERNELS = r"repro::.*flash"


def p95(values: list):
    return float(np.percentile(values, 95)) if values else None


def pure_decode_step_ms(rec):
    """Median host ms of a window step that admitted no prompt (untraced:
    `Record.host_window`)."""
    ms = [(s.t1 - s.t0) * 1e3 for s in rec.host_steps() if not s.prefills]
    return statistics.median(ms) if ms else None


def step_ms(rec):
    """Median host ms of a window step (untraced: `Record.host_window`)."""
    ms = [(s.t1 - s.t0) * 1e3 for s in rec.host_steps()]
    return statistics.median(ms) if ms else None


def token_gap_p95_ms(rec):
    """95th percentile of the gaps between a request's successive tokens
    whose later token came in the untraced window."""
    t0, t1 = rec.host_window
    gaps = [(b - a) * 1e3 for r in rec.requests
            for a, b in zip(r.stamps, r.stamps[1:]) if t0 < b <= t1]
    return p95(gaps)


def mfu_pct(rec):
    """Model FLOPs of every token prefilled and decoded in the untraced
    window over its seconds at the bf16 peak, in %."""
    s = rec.shape
    t0, t1 = rec.host_window
    flops = sum(sum(work.prefill_flops(s, n) for n in st.prefills)
                + sum(work.decode_flops(s, k) for k in st.decode_keys)
                for st in rec.host_steps())
    return 100.0 * flops / ((t1 - t0) * work.PEAK_FLOPS[s.dtype])


def roofline_pct(rec, kernels: str, bound) -> float | None:
    """The least time of the traced steps' work (`bound(step)` seconds a
    step) over the device time of the kernels named by `kernels`, in %."""
    tr = rec.trace
    if tr is None:
        return None
    t = tr.device_seconds(kernels)
    if t <= 0:
        return None
    least = sum(bound(st) for st in rec.steps if st.idx in tr.steps)
    return 100.0 * least / t


def decode_bound_s(rec, st) -> float:
    if not st.decode_keys:
        return 0.0
    return work.bound_s(*work.decode_work(rec.shape, st.decode_keys),
                        rec.shape.dtype)


def flash_bound_s(rec, st) -> float:
    return sum(work.bound_s(*work.flash_work(rec.shape, n), rec.shape.dtype)
               for n in st.prefills)


def idle_pct(rec):
    tr = rec.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
