"""itl_p95_ms: 95th percentile gap between a request's successive tokens,
stamped at the step returns, over tokens emitted in the window (in a traced
run, before the profiler starts)."""
from cardbench.core.readings import token_gap_p95_ms


def read(rec):
    return token_gap_p95_ms(rec)
