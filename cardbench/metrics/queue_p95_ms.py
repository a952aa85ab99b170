"""queue_p95_ms: 95th percentile of a request's wait in the engine's queue,
from its submission to the start of its prefill (the engine's own stamps
``submitted_at`` and ``admitted_at``, ``time.perf_counter``), over the
requests due before the profiler starts; one never admitted counts its wait
to the run's end. None where the engine's requests carry no
``admitted_at`` stamp."""
from cardbench.core.readings import p95


def read(rec):
    reqs = [r.handle for r in rec.due_in_host_window()
            if r.handle is not None]
    if not reqs or not hasattr(reqs[0], "admitted_at"):
        return None
    return p95([((h.admitted_at if h.admitted_at >= 0 else rec.end)
                 - h.submitted_at) * 1e3 for h in reqs])
