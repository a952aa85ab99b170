"""decode_step_ms: median host ms of an engine step in the window that
admitted no prompt (one decode step of every slot), from the harness's
spans around ``engine.step``; in a traced run, before the profiler
starts."""
from cardbench.core.readings import pure_decode_step_ms


def read(rec):
    return pure_decode_step_ms(rec)
