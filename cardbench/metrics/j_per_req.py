"""j_per_req: the card's energy over the window over the requests
completed in it, in joules."""
import math


def read(rec):
    n = sum(1 for r in rec.requests if rec.in_window(r.done))
    if not n or math.isnan(rec.energy_j):
        return None
    return rec.energy_j / n
