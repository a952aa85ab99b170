"""out_tok_s: output tokens emitted inside the window, over the window (in
a traced run, the window up to the profiler's start)."""


def read(rec):
    t0, t1 = rec.host_window
    n = sum(1 for r in rec.requests for t in r.stamps if t0 < t <= t1)
    return n / (t1 - t0)
