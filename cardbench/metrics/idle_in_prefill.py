"""idle_in_prefill: share of the traced span's device idle time in which the
host was admitting a prompt (between a request's ``admitted_at`` and
``first_token_at`` stamps: the engine's ``engine.prefill`` span), in %. The
stamps (``time.perf_counter``) are put on the trace's clock by the
harness's step ranges (`ranges.trace_offset_ns`). None without a trace or
without the stamps."""
from cardbench.core import ranges


def read(rec):
    off = ranges.trace_offset_ns(rec)
    spans = ranges.prefill_intervals(rec)
    if off is None or spans is None:
        return None
    idle = ranges.idle_gaps(rec.trace)
    total = sum(b - a for a, b in idle)
    if total <= 0:
        return None
    inside = ranges.overlap(idle, ranges.union((a * 1e9 + off, b * 1e9 + off)
                                               for a, b in spans))
    return 100.0 * inside / total
