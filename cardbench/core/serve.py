"""Drive the engine under a traffic mix: the lead-in, the measured window
and the tail, with every step and every token stamped on the harness's own
clock (``time.perf_counter`` at the return of the step that produced it).

The window opens and closes at step boundaries: it opens at the first
boundary after the lead-in and closes at the first boundary ``seconds``
later, so it holds whole steps. An open loop submits each request when it
falls due and is timed from its due time; a closed loop's client sends its
next request at the step return that completed its last one. A tail of
the same traffic follows the window, so that requests due late in it are
judged on what happens to them, not cut off.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import sys
import time

from cardbench.core import traffic as T

clock = time.perf_counter


@dataclasses.dataclass
class Served:
    item: T.Item
    prompt: list
    due: float = math.nan
    submitted: float = math.nan
    stamps: list = dataclasses.field(default_factory=list)
    done: float = math.nan
    handle: object = None

    @property
    def tokens(self) -> list:
        return list(self.handle.generated)


@dataclasses.dataclass
class Step:
    idx: int
    t0: float
    t1: float
    prefills: list          # prompt lengths prefilled in the step
    decode_keys: list       # positions each decoded request attended
    traced: bool = False


@dataclasses.dataclass
class Record:
    """What a run saw; the metric readers take it."""
    shape: object                # the configuration's family's shape
    window: tuple                # (t0, t1), host seconds
    end: float                   # the end of the tail
    steps: list
    requests: list
    setup_s: float = math.nan
    energy_j: float = math.nan
    trace: object = None         # profile.Trace in a traced run

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def in_window(self, t: float) -> bool:
        return self.window[0] <= t <= self.window[1]

    def due_in_window(self) -> list:
        t0, t1 = self.window
        return [r for r in self.requests if t0 <= r.due < t1]

    def due_in_host_window(self) -> list:
        """The requests due in `host_window`: all those due in the window
        of an untraced run."""
        t0, t1 = self.host_window
        return [r for r in self.requests if t0 <= r.due < t1]

    def window_steps(self) -> list:
        t0, t1 = self.window
        return [s for s in self.steps if s.t0 >= t0 and s.t1 <= t1]

    @property
    def host_window(self) -> tuple:
        """The window up to the first traced step: where host times are
        read in a traced run (the profiler slows the host), and the whole
        window otherwise."""
        traced = [s.t0 for s in self.steps if s.traced]
        return (self.window[0], min(traced) if traced else self.window[1])

    def host_steps(self) -> list:
        t0, t1 = self.host_window
        return [s for s in self.steps if s.t0 >= t0 and s.t1 <= t1]


class Source:
    """Requests as they fall due."""

    def __init__(self, mix: dict, seed: int, vocab: int, seconds: float,
                 rate: float | None):
        self.mix, self.seed, self.vocab = mix, seed, vocab
        self.closed = mix["loop"] == "closed"
        if self.closed:
            self.lists = [collections.deque(x) for x in T.closed_lists(mix)]
            self.ready = collections.deque()
        else:
            self.sched = collections.deque(
                T.open_schedule(mix, rate, seconds))

    def _served(self, it: T.Item, due: float) -> Served:
        return Served(item=it, prompt=T.prompt_ids(self.seed, it, self.vocab),
                      due=due)

    def start(self, t: float) -> None:
        self.origin = t
        if self.closed:
            self.ready.extend(self._served(q.popleft(), t)
                              for q in self.lists)

    def due(self, now: float) -> list:
        out = []
        if self.closed:
            while self.ready and self.ready[0].due <= now:
                out.append(self.ready.popleft())
        else:
            while self.sched and self.origin + self.sched[0].offset <= now:
                it = self.sched.popleft()
                out.append(self._served(it, self.origin + it.offset))
        return out

    def next_due(self) -> float:
        if self.closed:
            return self.ready[0].due if self.ready else math.inf
        return self.origin + self.sched[0].offset if self.sched else math.inf

    def completed(self, r: Served, t: float) -> None:
        if self.closed:
            q = self.lists[r.item.client]
            if not q:
                raise RuntimeError("a client ran out of requests: raise the "
                                   "mix's pool_size")
            self.ready.append(self._served(q.popleft(), t))


def warm_up(engine, mix: dict, vocab: int) -> None:
    """One prefill at every prompt bucket of the mix, then decode steps at
    the engine's full batch, until the engine is idle."""
    for n in T.warm_lengths(mix):
        engine.submit([(7 * i + 3) % vocab for i in range(n)],
                      max_new_tokens=2)
    engine.run_until_idle()


def warm_profiler(sync) -> None:
    """Start and stop ``torch.profiler`` once around a trivial device
    operation, so that the traced run's start inside the window is cheap."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(8, device="cuda" if torch.cuda.is_available()
                   else "cpu").sum().item()
        sync()


def drive(engine, source: Source, *, lead_in: float, seconds: float,
          tail: float, meter=None, profile_at: float | None = None,
          sync=lambda: None):
    """Run the traffic to the end of the tail. Returns (requests, steps,
    window, end, energy J, the profiler or None). With `profile_at` the
    steps from `profile_at` seconds into the window to its end run under
    ``torch.profiler``, each in a ``cardbench.step.<n>`` range; the
    profiler stops once the window has closed, so that what stopping costs
    falls outside it. (Start it once in set-up, `warm_profiler`: its first
    start in a process initialises the device tracing, which took 9 s on
    the H100.)"""
    from torch.profiler import ProfilerActivity, profile, record_function
    inflight, served, steps = [], [], []
    t_start = clock()
    source.start(t_start)
    t0 = t1 = None
    energy = math.nan
    prof, p_end, profiled = None, None, None      # p_end: started
    while True:
        now = clock()
        if t0 is None and now >= t_start + lead_in:
            t0 = now
            if meter:
                meter.start()
        elif t0 is not None and t1 is None and now >= t0 + seconds:
            t1 = now
            if meter:
                energy = meter.stop()
            if prof is not None:        # the traced span ends with it
                sync()
                prof.stop()
                profiled, prof = prof, None
                print(f"cardbench: profiler stopped in {clock() - t1:.3f} s",
                      file=sys.stderr, flush=True)
        if t1 is not None and now >= t1 + tail:
            break
        if (profile_at is not None and prof is None and t0 is not None
                and t1 is None and now >= t0 + profile_at and p_end is None):
            sync()
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.start()
            p_end = clock()
            print(f"cardbench: profiler started in {p_end - now:.3f} s",
                  file=sys.stderr, flush=True)
        for r in source.due(now):
            r.handle = engine.submit(r.prompt, max_new_tokens=r.item.max_new)
            r.submitted = clock()
            inflight.append(r)
            served.append(r)
        if not inflight:
            phase = (t_start + lead_in if t0 is None
                     else t0 + seconds if t1 is None else t1 + tail)
            wake = min(source.next_due(), phase)
            time.sleep(max(0.0, wake - clock()))
            continue
        idx = len(steps)
        ts = clock()
        if prof is not None:
            with record_function(f"cardbench.step.{idx}"):
                engine.step()
        else:
            engine.step()
        te = clock()
        prefills, keys, still = [], [], []
        for r in inflight:
            g = len(r.handle.generated)
            new = g - len(r.stamps)
            if new:
                fresh = not r.stamps
                if fresh:
                    prefills.append(len(r.prompt))
                if new - fresh >= 1:
                    keys.append(len(r.prompt) + g - 1)
                r.stamps.extend([te] * new)
            if r.handle.done:
                r.done = te
                source.completed(r, te)
            else:
                still.append(r)
        inflight = still
        steps.append(Step(idx, ts, te, prefills, keys,
                          traced=prof is not None))
    sync()
    return served, steps, (t0, t1), clock(), energy, profiled
