"""ttft_p95_ms: 95th percentile of the time to first token over every
request due in the window, from its due time; a request with no token by
the end of the run counts at its wait so far (in a traced run, those due
before the profiler starts)."""
from cardbench.core.readings import p95


def read(rec):
    return p95([((r.stamps[0] if r.stamps else rec.end) - r.due) * 1e3
                for r in rec.due_in_host_window()])
