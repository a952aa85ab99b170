"""step_ms: median host ms of an engine step in the window (admission with
its batch-1 prefills, then one decode step of every slot), from the
harness's spans around ``engine.step``; in a traced run, before the
profiler starts."""
from cardbench.core.readings import step_ms


def read(rec):
    return step_ms(rec)
