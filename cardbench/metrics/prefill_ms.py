"""prefill_ms: median host ms of a prompt's admission (its batch-1 bucket
prefill, the first token's read and the slot insert: the engine's
``engine.prefill`` span), from the engine's own stamps ``admitted_at`` to
``first_token_at`` (``time.perf_counter``), over the admissions begun and
ended before the profiler starts. None where the engine's requests carry
no ``admitted_at`` stamp."""
import statistics

from cardbench.core.ranges import prefill_intervals


def read(rec):
    spans = prefill_intervals(rec)
    if spans is None:
        return None
    t0, t1 = rec.host_window
    ms = [(b - a) * 1e3 for a, b in spans if t0 <= a and b <= t1]
    return statistics.median(ms) if ms else None
