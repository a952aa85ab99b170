"""mfu: model FLOPs of every token prefilled and decoded in the traced
run's window before the profiler starts (2 x matrix parameters a token,
routed experts at top-k, the head once a produced token, attention over
each token's real context) over those seconds x 989 TF/s, in %."""
from cardbench.core.readings import mfu_pct


def read(rec):
    return mfu_pct(rec)
