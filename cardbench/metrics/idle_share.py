"""idle_share: share of the profiled span in which no operation ran on the
card, in %."""
from cardbench.core.readings import idle_pct


def read(rec):
    return idle_pct(rec)
