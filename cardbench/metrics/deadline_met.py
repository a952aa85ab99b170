"""deadline_met: share of the requests due in the window that finished
within their own processing-time requirement (due to last token), in %.
An unfinished or failed request misses. In a traced run, the requests due
before the profiler starts."""


def read(rec):
    due = rec.due_in_host_window()
    if not due:
        return None
    met = sum(1 for r in due
              if r.done - r.due <= r.item.deadline
              and len(r.stamps) == r.item.max_new)
    return 100.0 * met / len(due)
