"""Event-driven runtime API: one event loop behind `drive_slot`.

The scheduling contract (`repro_torch.core.api`) says *what* a policy decides;
this module says *when* the runtime asks. Both runtimes — the cluster
`Simulator` and the live `PerLLMServer` — are `Runtime`s: they own a
heap-ordered `EventLoop` of typed events, build a **fresh** `ClusterView`
at each arrival's actual timestamp, call `policy.assign` through
`drive_slot`, apply commit/deferral themselves, and emit `feedback` at the
request's true completion time. Arrivals, bandwidth fluctuation, dispatch
deferral and completions are all just event streams, so scenario shaping
(bursty/diurnal/trace arrivals, mid-run bandwidth drops) composes with any
runtime for free via `Scenario` hooks.

Event taxonomy
    Arrival          one or more requests hit the front door
    Deferred         a routed request's batching window opened
    TxDone           a request's uplink transfer completed
    InferStart       a batch lane began prefill/decode for a request
    InferDone        inference finished; the realized Outcome exists
    Reject           admission control shed the request (Decision.admit
                     False): the runtime emits a rejected Outcome with an
                     SLO-violation cost instead of queueing it forever
    Preempt          a running victim's batch lane is returned
                     (Decision.preempt_victim); its remaining decode
                     tokens are requeued as a new Arrival
    KvMigrate        a request's preserved KV pages finished transferring
                     across the link topology to another server
                     (Decision.migrate_kv); the request resumes there
                     with zero re-prefill
    BandwidthChange  a link's bandwidth factor changed (model resample or
                     scenario-injected multiplicative scale, per server
                     index or per named topology link)

Ordering: the loop pops by (time, kind-priority, insertion seq). Equal-time
ties resolve completions before new arrivals (feedback precedes the next
assign) and FIFO within a kind — which is what keeps shared uplinks FIFO
when arrival events are inserted out of order.

Layering: like `core.api`, this module is structural — it knows Decisions,
views and events, never server specs or engines. Physics (transmission,
lanes, energy) live in each runtime's subclass hooks.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.api import ClusterView, Decision, drive_slot, ensure_policy


# ---------------------------------------------------------------------------
# Events
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Event:
    """Base event: something happens at `time` (seconds)."""

    time: float
    priority = 5            # class-level tie-break; lower pops first


@dataclasses.dataclass(frozen=True)
class BandwidthChange(Event):
    """A link's bandwidth factor changes.

    `scale` maps server index -> multiplicative overlay on the bandwidth
    model's own factor (scenario-injected congestion/outage); `link_scale`
    does the same for named `LinkTopology` links (runtimes without a
    topology map unknown names onto nothing); `resample` marks the
    runtime's periodic re-draw of the fluctuating model itself.
    """

    scale: Optional[Dict[int, float]] = None
    link_scale: Optional[Dict[str, float]] = None
    resample: bool = False
    priority = 0


@dataclasses.dataclass(frozen=True)
class Reject(Event):
    """Admission control shed `request` at `time` (Decision.admit False).

    The runtime's `on_reject` emits a rejected Outcome — success False,
    an SLO-violation processing-time cost, zero server energy — so the
    policy's `feedback` still fires and aggregate metrics count the miss.
    """

    request: Any = None
    decision: Optional[Decision] = None
    priority = 1


@dataclasses.dataclass(frozen=True)
class Preempt(Event):
    """`request` (the preemptor) reclaims `victim`'s batch lane at `time`.

    Handled synchronously inside `Runtime.place`, *before* the preemptor
    dispatches, so the victim's lane is provably free by the preemptor's
    `InferStart`. The runtime requeues the victim's remaining decode
    tokens as a new Arrival at `time`. `drop_kv` is the KV-resume info
    (from `Decision.preempt_drop_kv`): False keeps the victim's KV pages
    resident — a same-server requeue then resumes without re-prefill —
    while True frees them immediately (memory-pressure eviction).
    """

    victim: Any = None          # victim request sid
    request: Any = None         # the preemptor
    decision: Optional[Decision] = None
    drop_kv: bool = False
    priority = 1


@dataclasses.dataclass(frozen=True)
class InferDone(Event):
    """Inference finished at `time`; feedback fires here."""

    request: Any = None
    context: Any = None     # runtime-private realization payload
    priority = 1


@dataclasses.dataclass(frozen=True)
class InferStart(Event):
    """A batch lane starts working. For the live server this is also the
    engine's decode tick (one real `ServingEngine.step`)."""

    request: Any = None
    server: int = -1
    context: Any = None
    priority = 2


@dataclasses.dataclass(frozen=True)
class KvMigrate(Event):
    """`request`'s preserved KV pages finished their cross-server
    transfer at `time` (booked on every link of the migration path when
    the move was decided — `Decision.migrate_kv`). The runtime's
    `on_kv_migrate` frees the source pages and resumes the request on
    the destination with zero re-prefill. `context` is runtime-private
    (source/destination bookkeeping)."""

    request: Any = None
    decision: Optional[Decision] = None
    context: Any = None
    priority = 2


@dataclasses.dataclass(frozen=True)
class TxDone(Event):
    """Uplink transfer complete; the request is on the server."""

    request: Any = None
    decision: Optional[Decision] = None
    context: Any = None
    priority = 3


@dataclasses.dataclass(frozen=True)
class Deferred(Event):
    """A routed request's dispatch window opened (`Decision.defer_until`)."""

    request: Any = None
    decision: Optional[Decision] = None
    priority = 4


@dataclasses.dataclass(frozen=True)
class Arrival(Event):
    """Requests arrive. Pure event-driven runtimes push one request per
    Arrival at its true timestamp; the slotted-compat mode pushes one
    Arrival per slot carrying the slot's whole batch (quantized arrivals),
    which is exactly the legacy semantics expressed as an event."""

    requests: Tuple[Any, ...] = ()
    slot_index: int = -1    # slotted-compat bookkeeping; -1 in event mode
    priority = 5


# ---------------------------------------------------------------------------
# EventLoop — a stable heap of events
# ---------------------------------------------------------------------------


class EventLoop:
    """Min-heap of events ordered by (time, kind priority, FIFO seq)."""

    def __init__(self) -> None:
        self._heap: List[Tuple[float, int, int, Event]] = []
        self._seq = 0

    def push(self, event: Event) -> None:
        heapq.heappush(self._heap,
                       (event.time, event.priority, self._seq, event))
        self._seq += 1

    def pop(self) -> Event:
        return heapq.heappop(self._heap)[-1]

    def __iter__(self):
        """Pending events, in no particular order (inspection only)."""
        return (item[-1] for item in self._heap)

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)


# ---------------------------------------------------------------------------
# Runtime — the event-driven side of the scheduling contract
# ---------------------------------------------------------------------------


class Runtime:
    """Owns the loop and the `ClusterView`; drives the policy.

    The generic machinery here is the contract's runtime half: per Arrival
    it builds a fresh view at the event's actual timestamp, collects one
    Decision per request via `drive_slot` (which commits residuals between
    requests), and applies each Decision's deferral by scheduling a
    `Deferred` event. Subclasses supply the physics:

        build_view(t)        fresh ClusterView from real state at time t
        dispatch(t, req, d)  start the request's transmission/execution
        on_tx_done / on_infer_start / on_infer_done / on_bandwidth_change
    """

    def __init__(self, policy, trace=None) -> None:
        self.policy = ensure_policy(policy)
        self.loop = EventLoop()
        self.clock = 0.0
        # optional repro_torch.obs.TraceRecorder; every emission site is
        # guarded by `if self.trace is not None` so the hot path is
        # untouched when tracing is off (docs/observability.md)
        self.trace = trace

    # ---------------- physics hooks (subclass) ---------------------------
    def build_view(self, t: float) -> ClusterView:
        raise NotImplementedError

    def dispatch(self, t: float, request, decision: Decision) -> None:
        raise NotImplementedError

    def on_tx_done(self, ev: TxDone) -> None:
        pass

    def on_infer_start(self, ev: InferStart) -> None:
        pass

    def on_infer_done(self, ev: InferDone) -> None:
        pass

    def on_bandwidth_change(self, ev: BandwidthChange) -> None:
        pass

    def on_reject(self, ev: Reject) -> None:
        pass

    def on_preempt(self, ev: Preempt) -> None:
        pass

    def on_kv_migrate(self, ev: "KvMigrate") -> None:
        pass

    # ---------------- generic driving ------------------------------------
    def slot_index(self, t: float) -> int:
        """Slot ordinal forwarded to `drive_slot` (diagnostics only);
        event-driven runtimes have no slots, so default to whole
        seconds."""
        return int(t)

    def on_arrival(self, ev: Arrival) -> None:
        view = self.build_view(ev.time)
        t_slot = ev.slot_index if ev.slot_index >= 0 \
            else self.slot_index(ev.time)
        decisions = drive_slot(self.policy, ev.requests, view, t_slot)
        for req, d in zip(ev.requests, decisions, strict=True):
            self.place(ev.time, req, d)

    def place(self, t: float, request, decision: Decision) -> None:
        """Apply one Decision: reject, preempt-then-dispatch, or defer.

        Rejections and preemptions are routed through `handle` as typed
        events — synchronously, so a preempted victim's lane is free
        before the preemptor's dispatch books it, and a rejection's
        feedback precedes any later arrival's `assign`."""
        if not decision.admit:
            self.handle(Reject(t, request=request, decision=decision))
            return
        if decision.preempt_victim is not None:
            self.handle(Preempt(t, victim=decision.preempt_victim,
                                request=request, decision=decision,
                                drop_kv=decision.preempt_drop_kv))
        when = max(t, decision.defer_until)
        if when > t:
            self.defer(t, when, request, decision)
        else:
            self.dispatch(t, request, decision)

    def defer(self, t: float, when: float, request,
              decision: Decision) -> None:
        self.loop.push(Deferred(when, request=request, decision=decision))

    def on_deferred(self, ev: Deferred) -> None:
        self.dispatch(ev.time, ev.request, ev.decision)

    _HANDLERS = {
        Arrival: "on_arrival", Deferred: "on_deferred",
        TxDone: "on_tx_done", InferStart: "on_infer_start",
        InferDone: "on_infer_done", BandwidthChange: "on_bandwidth_change",
        Reject: "on_reject", Preempt: "on_preempt",
        KvMigrate: "on_kv_migrate",
    }

    def handle(self, ev: Event) -> None:
        self.clock = max(self.clock, ev.time)
        for klass in type(ev).__mro__:       # subclassed events route to
            name = self._HANDLERS.get(klass)  # their base handler
            if name is not None:
                getattr(self, name)(ev)
                return
        raise TypeError(f"no handler for event {type(ev).__name__}")

    def step_event(self) -> Optional[Event]:
        """Pop and handle the next event; None when the loop is empty."""
        if not self.loop:
            return None
        ev = self.loop.pop()
        self.handle(ev)
        return ev

    def drain(self, max_events: int = 10_000_000) -> None:
        """Run until only housekeeping (BandwidthChange) events remain."""
        for _ in range(max_events):
            if not self.loop:
                return
            if all(isinstance(e, BandwidthChange) for e in self.loop):
                return
            self.handle(self.loop.pop())
        raise RuntimeError(f"runtime did not drain in {max_events} events")


# ---------------------------------------------------------------------------
# Scenario — event streams that shape a run
# ---------------------------------------------------------------------------


class Scenario:
    """Hooks that shape a run's arrival and bandwidth event streams.

    `arrival_times(n, rate, rng)` returns n monotone arrival timestamps —
    the workload generator calls it so a scenario changes *when* services
    arrive. `shape_requests(services, rng)` may additionally reshape what
    they ask for (prompt/payload mixes — e.g. `kv-pressure`'s long-context
    documents); the default is a no-op, so scenarios that only retime
    arrivals keep request draws bit-identical to the baseline.
    `bandwidth_events(horizon, n_servers)` returns `BandwidthChange`
    events the runtime injects (multiplicative overlay on the bandwidth
    model), enabling mid-run congestion/outage studies in either runtime
    mode.
    """

    name = "poisson"

    def arrival_times(self, n: int, rate: float, rng) -> np.ndarray:
        return np.cumsum(rng.exponential(1.0 / rate, size=n))

    def shape_requests(self, services: Sequence[Any], rng) -> None:
        """Mutate per-request requirements in place (default: none)."""

    def bandwidth_events(self, horizon: float,
                         n_servers: int) -> List[BandwidthChange]:
        return []


class PoissonScenario(Scenario):
    """The default stationary Poisson process (the paper's §4.2 workload)."""


class BurstScenario(Scenario):
    """Markov-modulated Poisson: calm/burst phases with exponential dwell
    times. The burst rate is `burst_factor`× the calm rate, with both
    scaled so the long-run (time-average) rate stays `rate` for any
    `burst_factor` and dwell mix."""

    name = "burst"

    def __init__(self, burst_factor: float = 4.0, calm_dwell: float = 20.0,
                 burst_dwell: float = 5.0):
        assert burst_factor > 0
        self.burst_factor = burst_factor
        self.calm_dwell = calm_dwell
        self.burst_dwell = burst_dwell

    def arrival_times(self, n: int, rate: float, rng) -> np.ndarray:
        # expected time in burst; solve frac*B + (1-frac)*C = rate with
        # B = burst_factor*C, so the long-run average rate is preserved
        frac = self.burst_dwell / (self.burst_dwell + self.calm_dwell)
        calm_rate = rate / (frac * self.burst_factor + (1.0 - frac))
        burst_rate = self.burst_factor * calm_rate
        times = np.empty(n)
        t, i = 0.0, 0
        burst = False
        phase_end = rng.exponential(self.calm_dwell)
        while i < n:
            r = burst_rate if burst else calm_rate
            t_next = t + rng.exponential(1.0 / r)
            if t_next >= phase_end:
                t = phase_end
                burst = not burst
                phase_end = t + rng.exponential(
                    self.burst_dwell if burst else self.calm_dwell)
                continue
            t = t_next
            times[i] = t
            i += 1
        return times


class DiurnalScenario(Scenario):
    """Sinusoidal rate modulation (a compressed day/night cycle), sampled
    by thinning a Poisson process at the peak rate."""

    name = "diurnal"

    def __init__(self, period: float = 120.0, depth: float = 0.8):
        assert 0.0 <= depth <= 1.0
        self.period = period
        self.depth = depth

    def arrival_times(self, n: int, rate: float, rng) -> np.ndarray:
        peak = rate * (1.0 + self.depth)
        times = np.empty(n)
        t, i = 0.0, 0
        while i < n:
            t += rng.exponential(1.0 / peak)
            lam = rate * (1.0 + self.depth
                          * np.sin(2.0 * np.pi * t / self.period))
            if rng.uniform() * peak <= lam:
                times[i] = t
                i += 1
        return times


class TraceScenario(Scenario):
    """Trace-driven arrivals: replay explicit timestamps (cycled if the
    requested workload outgrows the trace)."""

    name = "trace"

    def __init__(self, times: Sequence[float]):
        if len(times) == 0:
            raise ValueError("TraceScenario needs at least one timestamp")
        self.times = np.sort(np.asarray(times, dtype=float))

    def arrival_times(self, n: int, rate: float, rng) -> np.ndarray:
        reps = -(-n // len(self.times))          # ceil division
        span = float(self.times[-1]) + 1.0 / max(rate, 1e-9)
        tiled = np.concatenate([self.times + k * span for k in range(reps)])
        return tiled[:n]


class OverloadScenario(Scenario):
    """Sustained λ above aggregate service capacity.

    Arrivals are Poisson at `factor ×` the nominal rate for the whole run
    — unlike `burst` there is no calm phase to drain the backlog, so
    queues grow without bound and *every* admitted-by-default request
    eventually misses its SLO. This is the regime where admission control
    is the only way to keep admitted-request SLOs (paper §3.3's
    constraint-satisfaction claim under overload)."""

    name = "overload"

    def __init__(self, factor: float = 3.0):
        assert factor > 0
        self.factor = factor

    def arrival_times(self, n: int, rate: float, rng) -> np.ndarray:
        return np.cumsum(rng.exponential(1.0 / (rate * self.factor), size=n))


class CloudOutageScenario(Scenario):
    """Mid-run cloud-uplink outage on the link topology.

    Scales the shared `edge-cloud` backhaul (and the `user-cloud` access
    link) to `scale` over the middle `[start_frac, stop_frac]` window —
    the link-topology generalization of `bwdrop`: with a `LinkTopology`
    every cloud-bound transfer contends on the dying backhaul; without
    one the per-server fallback scales the last server's link."""

    name = "cloud-outage"

    def __init__(self, scale: float = 0.05, start_frac: float = 0.3,
                 stop_frac: float = 0.6):
        self.scale = scale
        self.start_frac = start_frac
        self.stop_frac = stop_frac

    def bandwidth_events(self, horizon: float,
                         n_servers: int) -> List[BandwidthChange]:
        links_down = {"edge-cloud": self.scale, "user-cloud": self.scale}
        links_up = {name: 1.0 for name in links_down}
        j = n_servers - 1          # per-server fallback: the cloud
        return [
            BandwidthChange(self.start_frac * horizon,
                            scale={j: self.scale}, link_scale=links_down),
            BandwidthChange(self.stop_frac * horizon,
                            scale={j: 1.0}, link_scale=links_up),
        ]


class KVPressureScenario(Scenario):
    """Long-context load that exhausts KV *memory* before bandwidth.

    Prompts are stretched by `prompt_scale` (context-document services —
    the workload class that pins KV blocks for its whole lifetime) while
    payloads shrink by `payload_scale` (the documents are token-cheap to
    ship but block-expensive to hold), and arrivals run at a mild
    `factor ×` the nominal rate. On a testbed whose `ServerSpec`s model a
    block pool (`kv_blocks > 0`), admission and preemption are driven by
    `kv_free_blocks` exhaustion rather than uplink congestion — the edge
    regime the paged cache exists for. Without KV-modeled specs it is just
    a heavier, low-payload workload.
    """

    name = "kv-pressure"

    def __init__(self, prompt_scale: float = 4.0, payload_scale: float = 0.1,
                 factor: float = 1.5, max_prompt: int = 8192):
        assert prompt_scale > 0 and factor > 0
        self.prompt_scale = prompt_scale
        self.payload_scale = payload_scale
        self.factor = factor
        self.max_prompt = max_prompt

    def arrival_times(self, n: int, rate: float, rng) -> np.ndarray:
        return np.cumsum(rng.exponential(1.0 / (rate * self.factor), size=n))

    def shape_requests(self, services, rng) -> None:
        for r in services:
            r.prompt_tokens = int(min(r.prompt_tokens * self.prompt_scale,
                                      self.max_prompt))
            r.payload_bytes = float(r.payload_bytes * self.payload_scale)


class SharedPrefixScenario(Scenario):
    """System-prompt reuse: the ROADMAP's "millions of users" regime where
    most requests open with one of a small set of shared system prompts.

    Each request draws a prompt pool from a Zipf-like law over `n_pools`
    pools (rank-`zipf_a` weights — a few pools dominate, a long tail is
    nearly unique) and *prepends* a `prefix_tokens`-token system prompt:
    `prompt_tokens` grows by the prefix and the request carries
    (`prefix_id`, `prefix_tokens`) so KV-modeled runtimes know which
    admissions share resident pages. Arrivals stay the baseline Poisson
    process, so wins against the unshared baseline are request-for-request
    comparable.
    """

    name = "shared-prefix"

    def __init__(self, n_pools: int = 32, zipf_a: float = 1.2,
                 prefix_tokens: int = 256):
        assert n_pools > 0 and prefix_tokens > 0
        self.n_pools = n_pools
        self.zipf_a = zipf_a
        self.prefix_tokens = prefix_tokens

    def shape_requests(self, services, rng) -> None:
        w = 1.0 / np.arange(1, self.n_pools + 1) ** self.zipf_a
        pools = rng.choice(self.n_pools, size=len(services), p=w / w.sum())
        for r, pid in zip(services, pools, strict=True):
            r.prefix_id = int(pid)
            r.prefix_tokens = self.prefix_tokens
            r.prompt_tokens = int(r.prompt_tokens) + self.prefix_tokens


class BandwidthDropScenario(Scenario):
    """Poisson arrivals plus a mid-run uplink degradation: the last server
    (the cloud, by testbed convention) drops to `scale` over the middle
    `[start_frac, stop_frac]` window of the run — the paper's Fig. 2 cloud
    congestion, injected as BandwidthChange events."""

    name = "bwdrop"

    def __init__(self, scale: float = 0.35, start_frac: float = 0.3,
                 stop_frac: float = 0.6, server: int = -1):
        self.scale = scale
        self.start_frac = start_frac
        self.stop_frac = stop_frac
        self.server = server

    def bandwidth_events(self, horizon: float,
                         n_servers: int) -> List[BandwidthChange]:
        j = self.server % n_servers
        return [
            BandwidthChange(self.start_frac * horizon, scale={j: self.scale}),
            BandwidthChange(self.stop_frac * horizon, scale={j: 1.0}),
        ]


# ---------------------------------------------------------------------------
# Scenario registry (same idiom as the policy registry)
# ---------------------------------------------------------------------------

_SCENARIOS: Dict[str, Tuple[str, Callable[..., Scenario]]] = {}


def _normalize(name: str) -> str:
    return "".join(c for c in name.lower() if c.isalnum())


def register_scenario(name: str, factory: Optional[Callable] = None):
    """Register a scenario factory under `name` (usable as a decorator)."""
    def _register(fac):
        _SCENARIOS[_normalize(name)] = (name, fac)
        return fac

    return _register(factory) if factory is not None else _register


def available_scenarios() -> List[str]:
    return sorted(display for display, _ in _SCENARIOS.values())


def make_scenario(name: str, **kwargs) -> Scenario:
    key = _normalize(name)
    if key not in _SCENARIOS:
        raise KeyError(f"unknown scenario {name!r}; available: "
                       + ", ".join(available_scenarios()))
    return _SCENARIOS[key][1](**kwargs)


register_scenario("poisson", PoissonScenario)
register_scenario("burst", BurstScenario)
register_scenario("diurnal", DiurnalScenario)
register_scenario("trace", TraceScenario)
register_scenario("bwdrop", BandwidthDropScenario)
register_scenario("overload", OverloadScenario)
register_scenario("cloud-outage", CloudOutageScenario)
register_scenario("kv-pressure", KVPressureScenario)
register_scenario("shared-prefix", SharedPrefixScenario)


__all__ = [
    "Arrival", "BandwidthChange", "BandwidthDropScenario", "BurstScenario",
    "CloudOutageScenario", "Deferred", "DiurnalScenario", "Event",
    "EventLoop", "InferDone", "InferStart", "KVPressureScenario",
    "KvMigrate", "OverloadScenario", "PoissonScenario", "Preempt",
    "Reject", "Runtime", "Scenario", "SharedPrefixScenario",
    "TraceScenario", "TxDone", "available_scenarios", "make_scenario",
    "register_scenario",
]
