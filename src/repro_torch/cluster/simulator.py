"""Discrete-event simulator for edge-cloud LLM serving.

Faithful to the paper's evaluation protocol (§4): services arrive in real
time, are scheduled to a server, upload over that server's (shared, possibly
fluctuating) uplink, then occupy a batch lane for prefill+decode. Processing
time = transmission + queue + inference; energy = transmission + inference +
idle (idle accrues over the run's makespan).

The simulator is purely event-driven, on the shared `Runtime` /
`EventLoop` from `repro_torch.core.runtime`: every service is its own `Arrival`
at its true timestamp, observed against a *fresh* view of live uplink/
lane state; transmission and completion unfold as `TxDone`/`InferDone`
events and the policy's `feedback` fires at the request's actual
completion time. Bandwidth fluctuation is a periodic `BandwidthChange`
resample stream. (The historical quantized-slot compat mode was retired
once the array-backed event core became the single measured path; a
numeric `slot=` argument now raises.)

Two interchangeable cores execute those semantics: the default array-
backed core (`core="array"`: flat typed event heap, cached bandwidth/
uplink vectors, lazily materialized views) and the straight-line
reference core (`core="reference"`), kept as the readable specification —
trajectories are bit-identical between them (see
tests/test_scale_equivalence.py).

Scenario hooks (`repro_torch.core.runtime.Scenario`) inject extra event streams —
bursty/diurnal/trace arrivals shape the workload (see
`workload.generate_workload`), and mid-run bandwidth drops arrive as
`BandwidthChange` scale overlays (per server or per named link) honored by
both modes.

The network is a `LinkTopology` (default: the degenerate one-private-link
per server, bit-exact with the legacy per-server `BandwidthModel`):
transfers serialize on every link of the target server's path at the
path's bottleneck bandwidth. Policies may shed arrivals
(`Decision.admit=False` — a `Reject` event emits the SLO-violation
Outcome with zero server energy) and reclaim a running
victim's lane (`Decision.preempt_victim` — the victim's remaining decode
tokens requeue as a fresh Arrival). The KV ledger also models *sharing*
and *mobility*: requests carrying a `prefix_id` reuse resident shared-prefix
pages (skipping that much prefill), and a cross-server requeue with
`Decision.migrate_kv` ships its preserved pages over the link topology
(`KvMigrate`) instead of abandoning them to a full re-prefill.

Servers have *hidden* efficiency factors and per-request noise — schedulers
only observe realized outcomes, which is what makes the bandit formulation
meaningful (and is how the real testbed behaves).
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.cluster.network import BandwidthModel, LinkStateMixin, LinkTopology
from repro_torch.cluster.server import ServerSpec, ServerState
from repro_torch.cluster.workload import ServiceRequest, classify
from repro_torch.core.api import (
    NOMINAL, Allocation, ClusterView, Decision, RunningTask, ensure_policy,
)
from repro_torch.core.runtime import (
    Arrival, BandwidthChange, EventLoop, InferDone, KvMigrate, Preempt,
    Reject, Runtime, Scenario, TxDone, make_scenario,
)
from repro_torch.obs.metrics import MetricsRegistry, counter_attr, with_aliases
from repro_torch.obs.trace import (
    KIND_ARRIVAL, KIND_DECISION, KIND_KV_WAIT, KIND_MIGRATE,
    KIND_PREEMPT, KIND_REJECT, KIND_RESUME,
)


@dataclasses.dataclass(slots=True)
class Outcome:
    server: int
    tx_time: float
    queue_time: float
    infer_time: float
    finish: float
    processing_time: float
    success: bool
    energy: float               # incremental (tx + active-infer) energy
    rejected: bool = False      # admission control shed this request


@dataclasses.dataclass
class SimResult:
    name: str
    n_services: int
    success_rate: float
    avg_processing_time: float
    p95_processing_time: float
    throughput_tokens_per_s: float
    makespan: float
    e_tx: float
    e_infer: float
    e_idle: float
    per_server_served: List[int]
    # admission control & preemption (0 when disabled — legacy behavior)
    n_rejected: int = 0
    n_preempted: int = 0
    admitted_success_rate: float = 0.0   # SLO rate among admitted requests
    # paged KV cache (0 when no ServerSpec models a block pool)
    n_kv_evictions: int = 0              # preemptions that touched KV pages
    kv_prefill_tokens_saved: int = 0     # prefill skipped via page resume
    # prefix sharing & KV migration (0 when nothing shares or moves)
    n_prefix_hits: int = 0               # dispatches that reused a resident prefix
    n_kv_orphaned: int = 0               # cross-server requeues that abandoned pages
    n_kv_migrations: int = 0             # page transfers shipped between servers
    kv_migrated_bytes: float = 0.0       # bytes those transfers put on the links
    # directly accumulated prompt+output tokens of served requests (the
    # exact integer `throughput_tokens_per_s * makespan` reconstructs
    # lossily); 0 only for empty runs and legacy-constructed results
    served_tokens: int = 0

    # `metrics` (a repro_torch.obs.MetricsRegistry, attached by `_aggregate`)
    # is a plain attribute, not a dataclass field: it carries the full
    # labeled counter/gauge/histogram registry the scalar fields above
    # are views of, without entering equality comparisons.
    metrics = None

    @property
    def total_energy(self) -> float:
        return self.e_tx + self.e_infer + self.e_idle

    @property
    def energy_per_token(self) -> float:
        """Joules of total (tx + inference + idle) energy per served
        token — the benchmark gate's allocation-efficiency metric."""
        tokens = self.served_tokens if self.served_tokens > 0 \
            else self.throughput_tokens_per_s * self.makespan
        return self.total_energy / tokens if tokens > 0 else 0.0

    def stats(self) -> Dict[str, object]:
        """Canonical-key stats dict (shared naming with
        `PerLLMServer.stats` / `ServingEngine.stats`), with the
        deprecated old-name aliases included for one release."""
        return with_aliases({
            "n_served": sum(self.per_server_served),
            "n_rejected": self.n_rejected,
            "n_preempted": self.n_preempted,
            "n_kv_migrations": self.n_kv_migrations,
            "kv_migrated_bytes": self.kv_migrated_bytes,
            "n_prefix_hits": self.n_prefix_hits,
            "kv_prefill_tokens_saved": self.kv_prefill_tokens_saved,
            "admitted_success_rate": self.admitted_success_rate,
            "avg_processing_time": self.avg_processing_time,
            "per_server_served": list(self.per_server_served),
            "served_tokens": self.served_tokens,
        })

    @classmethod
    def empty(cls, name: str, n_servers: int) -> "SimResult":
        """Zeroed result for a run that produced no outcomes."""
        return cls(name=name, n_services=0, success_rate=0.0,
                   avg_processing_time=0.0, p95_processing_time=0.0,
                   throughput_tokens_per_s=0.0, makespan=0.0,
                   e_tx=0.0, e_infer=0.0, e_idle=0.0,
                   per_server_served=[0] * n_servers)

    def row(self) -> str:
        extra = ""
        if self.n_rejected or self.n_preempted:
            extra = (f" adm_succ={self.admitted_success_rate*100:5.1f}%"
                     f" rej={self.n_rejected} pre={self.n_preempted}")
        if self.n_prefix_hits or self.n_kv_migrations or self.n_kv_orphaned:
            extra += (f" pfx={self.n_prefix_hits}"
                      f" mig={self.n_kv_migrations}"
                      f" orph={self.n_kv_orphaned}")
        return (f"{self.name:22s} succ={self.success_rate*100:5.1f}% "
                f"time={self.avg_processing_time:6.2f}s "
                f"thpt={self.throughput_tokens_per_s:8.1f} tok/s "
                f"energy={self.total_energy/1e3:8.1f} kJ "
                f"(tx={self.e_tx/1e3:.1f} inf={self.e_infer/1e3:.1f} "
                f"idle={self.e_idle/1e3:.1f})" + extra)


# ---------------------------------------------------------------------------
# Runtimes — simulator physics behind the shared event loop
# ---------------------------------------------------------------------------


def rejected_outcome(req, decision: Decision, t: float) -> Outcome:
    """The Outcome admission control emits for a shed request.

    The SLO-violation cost is a full deadline overshoot
    (`processing_time = 2×deadline`, i.e. normalized time slack −1) with
    success False; the request never touches a server, so no transmission
    or inference energy is charged anywhere. One definition shared by the
    simulator and the live server."""
    return Outcome(server=decision.server, tx_time=0.0, queue_time=0.0,
                   infer_time=0.0, finish=t,
                   processing_time=2.0 * req.deadline, success=False,
                   energy=0.0, rejected=True)


class _SimRuntimeBase(Runtime, LinkStateMixin):
    """Shared state for both simulator modes: server bookkeeping, the lane
    ledger, and the link topology's mutable state (per-link backlog and
    scenario scale overlays).

    Run counters live in a `repro_torch.obs.MetricsRegistry` (`self.metrics`):
    the class-level `counter_attr` properties below keep every existing
    ``self.n_rejected += 1`` call site working while `SimResult` /
    exporters read straight out of the registry. The registry slot holds
    the plain Python number assigned, so accumulation order — and
    bit-identity with the pre-registry code — is unchanged.
    """

    n_rejected = counter_attr("n_rejected")
    n_preempted = counter_attr("n_preempted")
    n_kv_evictions = counter_attr("n_kv_evictions")
    kv_prefill_tokens_saved = counter_attr("kv_prefill_tokens_saved")
    n_prefix_hits = counter_attr("n_prefix_hits")
    n_kv_orphaned = counter_attr("n_kv_orphaned")
    n_kv_migrations = counter_attr("n_kv_migrations")
    kv_migrated_bytes = counter_attr("kv_migrated_bytes")

    def __init__(self, sim: "Simulator", policy, trace=None) -> None:
        super().__init__(policy, trace=trace)
        self.sim = sim
        self.specs = sim.specs
        self.init_link_state(sim.topology)
        self.topo = self.topology
        self.states = [ServerState(spec=s) for s in self.specs]
        self.lane_free = [[0.0] * s.max_concurrency for s in self.specs]
        self.outcomes: List[Outcome] = []
        self.metrics = MetricsRegistry()
        self.n_rejected = 0
        self.n_preempted = 0
        self.n_kv_evictions = 0
        self.kv_prefill_tokens_saved = 0
        self.n_prefix_hits = 0
        self.n_kv_orphaned = 0
        self.n_kv_migrations = 0
        self.kv_migrated_bytes = 0.0
        # KV-wait span bookkeeping, written only when tracing is on:
        # sid -> instant the request joined its server's kv_wait FIFO
        self._kv_wait_since: Dict[int, float] = {}

    def on_bandwidth_change(self, ev: BandwidthChange) -> None:
        self.apply_bandwidth_scales(ev)

    def server_factor(self, j: int, link_factors: Dict[str, float]) -> float:
        """Effective per-server bandwidth factor under current overlays."""
        return self.topo.server_factor(j, self.specs[j].bandwidth,
                                       link_factors, self.link_scale)

    def place(self, t: float, request, decision: Decision) -> None:
        # every event-routed arrival (seeded or requeued) lands its
        # ARRIVAL + DECISION rows here; the array core's direct-dispatch
        # fast branch (`_cursor_arrival`) emits its own. The guard
        # mirrors _trace_decision's only-requeues-and-sheds condition so
        # the happy path pays one comparison, not a call.
        if self.trace is not None and (request.preemptions
                                       or not decision.admit):
            self._trace_decision(t, request, decision)
        super().place(t, request, decision)

    def on_reject(self, ev: Reject) -> None:
        """Admission control shed a request: emit the rejected Outcome."""
        req = ev.request
        out = rejected_outcome(req, ev.decision, ev.time)
        req.finish = -1.0
        req.server = -1
        self.n_rejected += 1
        self.outcomes.append(out)
        if self.trace is not None:
            self.trace.append(KIND_REJECT, req.sid, ev.time, ev.time,
                              ev.decision.server, req.class_id)
        self.policy.feedback(req, out)

    # ---------------- trace emission helpers -----------------------------
    # All no-ops unless a recorder is attached; emissions read only plain
    # request/booking fields (no RNG, no lazy views, no ledger writes),
    # which is what keeps traced runs bit-identical to untraced ones.
    def _trace_decision(self, t: float, req, d: Decision) -> None:
        """ARRIVAL/DECISION markers for the *non-implicit* placements:
        requeues after preemption and admission sheds. Happy-path
        decisions emit nothing here — their decision time is the TX
        span's t0 and their server/tier ride on the completion spans —
        which keeps the traced hot path within the CI overhead gate."""
        if not req.preemptions and d.admit:
            return
        alloc = d.alloc
        tier = alloc.freq_tier if alloc is not None else 0
        sid, cls = req.sid, req.class_id
        self.trace.append_rows((
            (KIND_ARRIVAL, sid, t, t, -1, cls, 0, 0.0,
             req.preemptions, -1),
            (KIND_DECISION, sid, t, t, d.server, cls, tier, 0.0,
             d.admit, -1),
        ))

    def _trace_complete(self, req, j: int, lane: int, tier: int,
                        ready: float, begin: float, finish: float,
                        e_tx: float, e_inf: float,
                        success: bool) -> None:
        """Emit one completed request's lifecycle as a single compressed
        completion record (expanded to TX/QUEUE/INFER/DONE rows at
        materialization). TX runs arrival→ready (uplink wait + transfer,
        the Outcome's `tx_time` window), QUEUE ready→begin, INFER
        begin→finish; the three spans telescope to exactly
        `processing_time` (property-tested)."""
        self.trace.complete(req.sid, req.arrival, ready, begin, finish,
                            j, req.class_id, tier, lane, e_tx, e_inf,
                            req.output_tokens, success)

    def _trace_dispatch_kv(self, t: float, req, j: int,
                           kv_resumed: bool) -> None:
        """KV_WAIT span (if the request sat in the kv_wait FIFO) and the
        RESUME marker (zero-re-prefill dispatch on preserved pages)."""
        tr = self.trace
        since = self._kv_wait_since.pop(req.sid, None)
        if since is not None:
            tr.append(KIND_KV_WAIT, req.sid, since, t, j, req.class_id)
        if kv_resumed:
            tr.append(KIND_RESUME, req.sid, t, t, j, req.class_id)


@dataclasses.dataclass(eq=False, slots=True)
class _Booking:
    """One dispatched request's committed physics (identity-hashed so a
    cancelled booking can never be confused with its requeue's)."""

    request: ServiceRequest
    j: int
    li: int                 # lane index booked on server j
    lane_prev: float        # lane value before this booking (for rollback)
    tx_dur: float
    charge_from: float      # tx-energy window start (arrival, or the
    #                         requeue instant for preempted continuations —
    #                         the pre-preemption window was already billed)
    ready: float            # transfer complete (uplink wait + tx)
    begin: float            # lane booking start
    t_inf: float
    finish: float
    cancelled: bool = False
    kv_resumed: bool = False  # decode-only window (pages survived eviction)
    prefix_saved: int = 0     # prompt tokens a resident shared prefix skipped
    alloc: Allocation = NOMINAL  # the Decision's resource allocation


@dataclasses.dataclass
class _PrefixEntry:
    """Resident shared-prefix pages on one server.

    The entry *owns* its blocks in the server's KV ledger — they are
    charged to `kv_used` when the entry is created (out of the creating
    request's full claim) and returned when the entry is reclaimed — so
    every sharer charges only its unique suffix. `ready` is the instant
    the creator's prefill materializes the pages; dispatches before it
    pay full prefill, dispatches after it skip the prefix."""

    blocks: int          # full KV blocks the resident prefix spans
    tokens: int          # blocks × kv_block_tokens
    refs: int            # live dispatched requests pinning the entry
    ready: float         # prefill-complete instant (hits need t >= ready)
    stamp: float         # last touch, for LRU reclaim of idle entries


class _LazyViewList(list):
    """ClusterView list field materialized on first read.

    The fill callback snapshots runtime state; it runs (at most once)
    inside the policy's `assign`, before any state mutates, so the
    content is identical to an eager snapshot at view-build time. Fields
    most policies never touch (`running`, `tier_load`) then cost nothing
    per arrival."""

    __slots__ = ("_fill",)

    def __init__(self, fill):
        super().__init__()
        self._fill = fill

    def _ensure(self):
        fill, self._fill = self._fill, None
        if fill is not None:
            self.extend(fill())

    def __len__(self):
        self._ensure()
        return list.__len__(self)

    def __iter__(self):
        self._ensure()
        return list.__iter__(self)

    def __getitem__(self, i):
        self._ensure()
        return list.__getitem__(self, i)

    def __eq__(self, other):
        self._ensure()
        return list.__eq__(self, other)

    def __ne__(self, other):
        self._ensure()
        return list.__ne__(self, other)

    def __contains__(self, x):
        self._ensure()
        return list.__contains__(self, x)

    def __repr__(self):
        self._ensure()
        return list.__repr__(self)

    def index(self, *a):
        self._ensure()
        return list.index(self, *a)

    def count(self, x):
        self._ensure()
        return list.count(self, x)

    def copy(self):
        self._ensure()
        return list(self)

    __hash__ = None


class _LazyViewDict(dict):
    """ClusterView dict field materialized on first read (same snapshot
    argument as `_LazyViewList`)."""

    __slots__ = ("_fill",)

    def __init__(self, fill):
        super().__init__()
        self._fill = fill

    def _ensure(self):
        fill, self._fill = self._fill, None
        if fill is not None:
            dict.update(self, fill())

    def __len__(self):
        self._ensure()
        return dict.__len__(self)

    def __iter__(self):
        self._ensure()
        return dict.__iter__(self)

    def __getitem__(self, k):
        self._ensure()
        return dict.__getitem__(self, k)

    def __contains__(self, k):
        self._ensure()
        return dict.__contains__(self, k)

    def __eq__(self, other):
        self._ensure()
        return dict.__eq__(self, other)

    def __ne__(self, other):
        self._ensure()
        return dict.__ne__(self, other)

    def __repr__(self):
        self._ensure()
        return dict.__repr__(self)

    def get(self, k, default=None):
        self._ensure()
        return dict.get(self, k, default)

    def keys(self):
        self._ensure()
        return dict.keys(self)

    def values(self):
        self._ensure()
        return dict.values(self)

    def items(self):
        self._ensure()
        return dict.items(self)

    def copy(self):
        self._ensure()
        return dict(self)

    __hash__ = None


class _CountingLoop(EventLoop):
    """EventLoop that tracks how many pending events are real work
    (anything but `BandwidthChange`), so the fast drain's only-
    housekeeping-left termination check is O(1) instead of scanning the
    heap."""

    def __init__(self) -> None:
        super().__init__()
        self.n_work = 0

    def push(self, event) -> None:
        if event.priority != 0:          # BandwidthChange is priority 0
            self.n_work += 1
        super().push(event)


class _EventSimRuntime(_SimRuntimeBase):
    """Pure event-driven semantics — the array-backed fast core.

    Result-identical to `reference_sim._ReferenceEventRuntime` (the
    retained pre-vectorization implementation, pinned by property tests
    and the goldens), but engineered for million-arrival runs:

    * **Ledger vectors, not per-view rebuilds**: the per-server bandwidth
      factor and path-free-at vectors are maintained incrementally —
      updated at the events that change them (bandwidth changes, link
      bookings) — so `build_view` hands out copies instead of recomputing
      dict-driven topology walks per arrival.
    * **Lazy view fields**: `running`, `tier_load`, `link_bw` and
      `link_queue` materialize on first read inside the policy's
      `assign` (before any state mutates, so content is identical);
      policies that never read them no longer pay O(in-flight) snapshot
      cost on every arrival.
    * **Arrival cursor**: the sorted workload is walked with a cursor
      merged against the heap instead of pre-pushing one Arrival dataclass
      per service, with virtual sequence numbers reserved so every
      tie-break matches the seeded-heap ordering.
    * **Flat hot events**: TxDone/InferDone are pushed as raw
      `(time, priority, seq, booking)` heap entries and dispatched by a
      type switch in `drain`, skipping per-event dataclass allocation and
      the generic MRO handler walk. Rare events (bandwidth, deferrals,
      KV migrations, requeues) keep the generic dataclass path.

    Bookings stay in `_inflight` until completion, which is what gives
    views their `running` tasks and `Preempt` a victim ledger to roll
    back.
    """

    def __init__(self, sim: "Simulator", policy, trace=None) -> None:
        super().__init__(sim, policy, trace=trace)
        self.loop = _CountingLoop()
        self._link_factors: Dict[str, float] = \
            {n: 1.0 for n in self.topo.links}
        self._inflight: Dict[int, _Booking] = {}
        # paged-KV ledger: blocks in use per server, plus the FIFO of
        # routed requests waiting for their server's pool to free up
        self._kv_modeled = any(s.kv_blocks > 0 for s in self.specs)
        self.kv_used = [0] * len(self.specs)
        self.kv_wait: List[List[tuple]] = [[] for _ in self.specs]
        # single-use tokens: preemptor sid -> server whose drop_kv
        # preemption it issued; grants first claim on the freed blocks
        self._kv_express: Dict[int, int] = {}
        # shared-prefix ledger: per-server {prefix_id: _PrefixEntry} of
        # resident system-prompt pages, which dispatched request pins
        # which entry (sid -> (server, prefix_id)), and per-sid prefill
        # tokens the pending dispatch skips (consumed by `dispatch`)
        self._prefix: List[Dict[int, _PrefixEntry]] = \
            [{} for _ in self.specs]
        self._prefix_pin: Dict[int, tuple] = {}
        self._prefix_saved: Dict[int, int] = {}
        n = len(self.specs)
        self._n = n
        self._tiered = any(s.n_tiers > 1 for s in self.specs)
        # link topology index: which servers each link serves, and the
        # dedicated-link fast path (a single private link lets bookings
        # update the path-free vector without a path walk)
        topo = self.topo
        self._link_servers: Dict[str, List[int]] = \
            {name: [] for name in topo.links}
        for j in range(n):
            for name in topo.paths[j]:
                self._link_servers[name].append(j)
        self._single_link: List[Optional[str]] = []
        for j in range(n):
            path = topo.paths[j]
            if len(path) == 1 and self._link_servers[path[0]] == [j]:
                self._single_link.append(path[0])
            else:
                self._single_link.append(None)
        # incrementally maintained ledger vectors (the reference core
        # recomputes both per view)
        self._uplink_vec: List[float] = [0.0] * n
        # arrival cursor state (`seed_arrivals`)
        self._services: Optional[List[ServiceRequest]] = None
        if any(link.fluctuating for link in self.topo.links.values()):
            self._resample_factors(0.0)
        self._refresh_bandwidth_caches()

    # ---------------- bandwidth as an event stream -----------------------
    def _refresh_bandwidth_caches(self) -> None:
        """Recompute the per-server factor vector and the observed
        per-link bandwidth map. Only bandwidth events change either, so
        this runs per `BandwidthChange` instead of per arrival — same
        floats as the reference core's per-view recomputation."""
        factors, scale = self._link_factors, self.link_scale
        topo = self.topo
        self._factor_vec = [self.server_factor(j, factors)
                            for j in range(self._n)]
        self._link_bw_cache = {
            name: topo.links[name].capacity * factors.get(name, 1.0)
            * scale[name] for name in topo.links}

    def _resample_factors(self, t: float) -> None:
        k = int(round(t / self.sim.bw_interval))
        self._link_factors = self.topo.factors(k)
        self.loop.push(BandwidthChange(t + self.sim.bw_interval,
                                       resample=True))

    def on_bandwidth_change(self, ev: BandwidthChange) -> None:
        super().on_bandwidth_change(ev)
        if ev.resample:
            self._resample_factors(ev.time)
        self._refresh_bandwidth_caches()

    def _factor(self, j: int) -> float:
        return self._factor_vec[j]

    def on_reject(self, ev: Reject) -> None:
        """A previously preempted request shed on requeue must not leak
        the pages preserved for its resume."""
        req = ev.request
        if req.kv_server >= 0 and req.kv_blocks > 0:
            blocks, j = req.kv_blocks, req.kv_server
            req.kv_server, req.kv_blocks = -1, 0
            self._prefix_unpin(req, ev.time)
            self._kv_free(j, blocks, ev.time)
        super().on_reject(ev)

    # ---------------- link ledger ----------------------------------------
    def _book_links(self, path, end: float) -> None:
        """Advance every link on `path` to `end` and refresh the
        path-free-at vector of each server those links serve."""
        link_free = self.link_free
        for name in path:
            link_free[name] = end
        vec = self._uplink_vec
        paths = self.topo.paths
        done = set()
        for name in path:
            for j in self._link_servers[name]:
                if j not in done:
                    done.add(j)
                    vec[j] = max(link_free[lk] for lk in paths[j])

    # ---------------- the Runtime contract -------------------------------
    def slot_index(self, t: float) -> int:
        return int(t / self.sim.bw_interval)

    def _fill_running(self) -> List[List[RunningTask]]:
        per: List[List[RunningTask]] = [[] for _ in range(self._n)]
        for sid, b in self._inflight.items():
            req = b.request
            per[b.j].append(RunningTask(
                sid=sid, server=b.j, class_id=req.class_id,
                deadline_at=req.arrival + req.deadline,
                begin=b.begin, finish_est=b.finish,
                tier=b.alloc.freq_tier))
        return per

    def _fill_tier_load(self, t: float) -> List[List[float]]:
        # per-server tier state: committed in-flight lane-seconds per
        # DVFS tier (the within-batch commits stack on via the view's
        # own `commit`)
        tier_load = [[0.0] * s.n_tiers for s in self.specs]
        for b in self._inflight.values():
            k = b.alloc.freq_tier
            if k < 0:
                k = self.specs[b.j].nominal_tier
            tier_load[b.j][k] += max(b.finish - max(b.begin, t), 0.0)
        return tier_load

    def _fill_link_queue(self, t: float) -> Dict[str, float]:
        return {name: max(f - t, 0.0)
                for name, f in self.link_free.items()}

    def build_view(self, t: float) -> ClusterView:
        n = self._n
        kv_kwargs = {}
        if self._kv_modeled:
            # idle prefix entries are reclaimable page cache, so the view
            # reports them as free (mirroring PagedKVCache.free_blocks);
            # resident *ready* prefixes are surfaced so policies can rank
            # servers by expected prefix hit
            idle = [sum(e.blocks for e in self._prefix[j].values()
                        if e.refs <= 0) for j in range(n)]
            kv_kwargs = dict(
                kv_free_blocks=[self.specs[j].kv_blocks - self.kv_used[j]
                                + idle[j] for j in range(n)],
                kv_total_blocks=[self.specs[j].kv_blocks
                                 for j in range(n)],
                kv_prefix_tokens=[
                    {pid: e.tokens for pid, e in self._prefix[j].items()
                     if e.ready <= t} for j in range(n)])
        # direct construction (no dataclass __init__/kwarg machinery):
        # ClusterView is a plain dataclass with no __post_init__, so
        # assigning its instance dict wholesale is equivalent — this runs
        # once per arrival and the savings are real at 10^6 arrivals
        view = ClusterView.__new__(ClusterView)
        view.__dict__ = {
            "t": t,
            "specs": self.specs,
            "bw_factor": self._factor_vec.copy(),
            "uplink_free_at": self._uplink_vec.copy(),
            "lane_free": list(map(list.copy, self.lane_free)),
            "link_bw": _LazyViewDict(self._link_bw_cache.copy),
            "link_queue": _LazyViewDict(lambda: self._fill_link_queue(t)),
            "paths": self.topo.paths,
            "running": _LazyViewList(self._fill_running),
            "kv_free_blocks": kv_kwargs.get("kv_free_blocks"),
            "kv_total_blocks": kv_kwargs.get("kv_total_blocks"),
            "kv_prefix_tokens": kv_kwargs.get("kv_prefix_tokens"),
            "tier_load": (_LazyViewList(lambda: self._fill_tier_load(t))
                          if self._tiered else None),
        }
        return view

    # ---------------- shared-prefix ledger -------------------------------
    def _prefix_blocks(self, req: ServiceRequest, j: int) -> int:
        """Full KV blocks of `req`'s shared prefix on server j's block
        geometry (capped so at least one suffix token always remains —
        the same cap `PagedKVCache.match_prefix` applies)."""
        if req.prefix_id < 0 or req.prefix_tokens <= 0:
            return 0
        span = min(req.prefix_tokens, req.prompt_tokens - 1)
        return max(span, 0) // self.specs[j].kv_block_tokens

    def _kv_need(self, req: ServiceRequest, j: int, t: float) -> int:
        """Blocks `req` would claim on j right now: full need minus any
        *ready* resident prefix blocks it can share. Pure — admission and
        the kv-wait drain peek both call it at the same instant, so they
        always agree on whether a dispatch is a prefix hit."""
        need = self.specs[j].kv_blocks_needed(req.prompt_tokens,
                                              req.output_tokens)
        entry = self._prefix[j].get(req.prefix_id) \
            if req.prefix_id >= 0 else None
        if entry is not None and entry.ready <= t:
            need -= min(entry.blocks, self._prefix_blocks(req, j))
        return need

    def _prefix_attach(self, t: float, req: ServiceRequest, j: int) -> int:
        """Pin (or create) the prefix entry `req` uses on j; returns the
        prefill tokens this dispatch skips.

        First of its pool: the request becomes the entry's *creator* — the
        entry takes ownership of the prefix blocks out of the creator's
        just-claimed full allocation (`kv_used` already covers them) and
        `dispatch` stamps `ready` once the creator's prefill window is
        known. Later dispatches pin the entry and, when it is ready, skip
        `entry.tokens` of prefill while charging only their suffix."""
        p_blocks = self._prefix_blocks(req, j)
        if p_blocks <= 0:
            return 0
        bt = self.specs[j].kv_block_tokens
        entry = self._prefix[j].get(req.prefix_id)
        if entry is None:
            self._prefix[j][req.prefix_id] = _PrefixEntry(
                blocks=p_blocks, tokens=p_blocks * bt, refs=1,
                ready=float("inf"), stamp=t)
            req.kv_blocks -= p_blocks
            self._prefix_pin[req.sid] = (j, req.prefix_id)
            return 0
        if entry.ready > t:
            return 0         # still prefilling: this dispatch pays in full
        entry.refs += 1
        entry.stamp = t
        self._prefix_pin[req.sid] = (j, req.prefix_id)
        return min(entry.blocks, p_blocks) * bt

    def _prefix_unpin(self, req: ServiceRequest, t: float) -> None:
        """Drop `req`'s pin on its prefix entry. An entry whose prefill
        never completed (creator evicted mid-prefill) is removed outright
        — its pages hold garbage; ready entries linger unpinned as
        reclaimable page cache."""
        pin = self._prefix_pin.pop(req.sid, None)
        if pin is None:
            return
        j, pid = pin
        entry = self._prefix[j].get(pid)
        if entry is None:
            return
        entry.refs -= 1
        entry.stamp = t
        if entry.refs <= 0 and entry.ready > t:
            self.kv_used[j] -= entry.blocks
            del self._prefix[j][pid]

    def _prefix_reclaim(self, j: int, need: int, keep: int = -1) -> None:
        """LRU-evict idle (unpinned) prefix entries on j until `need`
        blocks fit — never the entry `keep`, which the requester is about
        to share."""
        table = self._prefix[j]
        cap = self.specs[j].kv_blocks
        while self.kv_used[j] + need > cap:
            idle = [(e.stamp, pid) for pid, e in table.items()
                    if e.refs <= 0 and pid != keep]
            if not idle:
                return
            _, pid = min(idle)
            self.kv_used[j] -= table.pop(pid).blocks

    # ---------------- paged-KV ledger ------------------------------------
    def _kv_admit(self, t: float, req: ServiceRequest,
                  decision: Decision, from_wait: bool = False) -> bool:
        """Claim KV blocks for `req` on its target server.

        True = blocks held (dispatch may proceed); False = the request
        joined the server's KV-wait queue (re-dispatched by `_kv_free`
        when blocks return). The queue is strictly FIFO with head-of-line
        blocking — a newcomer enqueues behind existing waiters even when
        its own allocation would fit, matching the paged
        `ServingEngine._admit` semantics (`from_wait` marks the drain
        path's own re-dispatches, which must not re-enqueue behind the
        waiters they precede). A requeued request whose preserved pages
        live on the *target* server resumes on its existing blocks; pages
        preserved on any *other* server migrate or are abandoned in
        `dispatch`, before admission runs. A request whose pool already
        holds its shared prefix (ready `_PrefixEntry`) claims only its
        unique suffix blocks and skips that much prefill."""
        j = decision.server
        spec = self.specs[j]
        if req.kv_server == j and req.kv_blocks > 0:
            return True                      # resume on the held pages
        full = spec.kv_blocks_needed(req.prompt_tokens, req.output_tokens)
        if full > spec.kv_blocks:
            # physically unfittable on this server (even an empty pool is
            # too small): a KV-blind policy routed it here, so the runtime
            # sheds it — crashing the run or queueing forever would lose
            # the request silently
            self.handle(Reject(t, request=req, decision=decision))
            return False
        need = self._kv_need(req, j, t)
        express = self._kv_express.pop(req.sid, -1) == j
        if self.kv_used[j] + need > spec.kv_blocks:
            # idle resident prefixes are just page cache — evict LRU ones
            # before making the request wait
            self._prefix_reclaim(j, need, keep=req.prefix_id)
        if self.kv_used[j] + need > spec.kv_blocks \
                or (self.kv_wait[j] and not (from_wait or express)):
            self.kv_wait[j].append((req, decision))
            if self.trace is not None:
                self._kv_wait_since.setdefault(req.sid, t)
            return False
        self.kv_used[j] += need
        req.kv_server, req.kv_blocks = j, need
        saved = self._prefix_attach(t, req, j)
        if saved:
            self._prefix_saved[req.sid] = saved
        return True

    def _kv_free(self, j: int, n_blocks: int, t: float) -> None:
        """Return blocks to server j's pool and re-dispatch every KV-wait
        request that now fits (FIFO, head-of-line blocking)."""
        self.kv_used[j] -= n_blocks
        assert self.kv_used[j] >= 0, (j, self.kv_used[j])
        while self.kv_wait[j]:
            req, decision = self.kv_wait[j][0]
            need = self._kv_need(req, j, t)
            if self.kv_used[j] + need > self.specs[j].kv_blocks:
                self._prefix_reclaim(j, need, keep=req.prefix_id)
                if self.kv_used[j] + need > self.specs[j].kv_blocks:
                    break
            self.kv_wait[j].pop(0)
            self.dispatch(t, req, decision, _from_kv_wait=True)

    def dispatch(self, t: float, req: ServiceRequest,
                 decision: Decision, _from_kv_wait: bool = False) -> None:
        j = decision.server
        spec = self.specs[j]
        st = self.states[j]
        if req.kv_server >= 0 and req.kv_server != j:
            if self._kv_migrate(t, req, decision):
                return       # pages in flight: KvMigrate re-dispatches
            # pages preserved on another server that can't (or weren't
            # asked to) migrate are abandoned: freed on their home server
            # — even when the *target* doesn't model KV, or the old pool
            # leaks those blocks forever — counted, and the request pays
            # full re-prefill wherever it lands
            self.n_kv_orphaned += 1
            self._prefix_unpin(req, t)
            self._kv_free(req.kv_server, req.kv_blocks, t)
            req.kv_server, req.kv_blocks = -1, 0
        kv_resumed = False
        prefix_saved = 0
        if spec.kv_blocks > 0:
            kv_resumed = req.kv_server == j and req.kv_blocks > 0
            if not self._kv_admit(t, req, decision,
                                  from_wait=_from_kv_wait):
                return                       # waiting on KV blocks
            prefix_saved = self._prefix_saved.pop(req.sid, 0)
        if self.trace is not None and (kv_resumed or self._kv_wait_since):
            self._trace_dispatch_kv(t, req, j, kv_resumed)
        alloc = decision.alloc
        free = self._uplink_vec[j]
        tx_start = t if t > free else free
        # a sub-unit bandwidth share stretches the transfer by 1/share and
        # occupies the path for the whole stretched window (exclusive-
        # window semantics: shares can never oversubscribe a link)
        share = self._factor_vec[j] * alloc.bw_share
        tx_dur = req.payload_bytes * 8.0 \
            / (spec.bandwidth * (share if share > 1e-9 else 1e-9))
        end = tx_start + tx_dur
        # a transfer occupies its whole path
        name = self._single_link[j]
        if name is not None:
            self.link_free[name] = end
            self._uplink_vec[j] = end
        else:
            self._book_links(self.topo.paths[j], end)
        st.uplink_free_at = end
        ready = end
        # the lane is booked at dispatch — the routed request is committed
        # capacity, visible to every later arrival's fresh view — while the
        # events below mark when its phases actually happen
        lanes = self.lane_free[j]
        li = 0
        lane_prev = lanes[0]
        for k in range(1, len(lanes)):
            v = lanes[k]
            if v < lane_prev:
                li = k
                lane_prev = v
        begin = ready if ready > lane_prev else lane_prev
        t_inf = self.sim._draw_infer(req, j, kv_resumed, alloc, prefix_saved)
        finish = begin + t_inf
        lanes[li] = finish
        pin = self._prefix_pin.get(req.sid)
        if pin is not None:
            # first dispatch of this pool's creator: the shared pages
            # materialize once its own prefill window has run
            entry = self._prefix[pin[0]].get(pin[1])
            if entry is not None and entry.ready == float("inf"):
                entry.ready = begin + spec.prefill_time(entry.tokens)
        ctx = _Booking(request=req, j=j, li=li, lane_prev=lane_prev,
                       tx_dur=tx_dur,
                       charge_from=t if req.preemptions else req.arrival,
                       ready=ready, begin=begin, t_inf=t_inf, finish=finish,
                       kv_resumed=kv_resumed, prefix_saved=prefix_saved,
                       alloc=alloc)
        self._inflight[req.sid] = ctx
        # flat hot events: the booking itself is the payload; priorities 3
        # (TxDone) and 1 (InferDone) are unique among pushed events, so
        # `drain` routes on them without per-event dataclass churn
        loop = self.loop
        heap = loop._heap
        heapq.heappush(heap, (ready, 3, loop._seq, ctx))
        heapq.heappush(heap, (finish, 1, loop._seq + 1, ctx))
        loop._seq += 2
        loop.n_work += 2

    def _kv_migrate(self, t: float, req: ServiceRequest,
                    decision: Decision) -> bool:
        """Ship `req`'s preserved pages from their home server to
        `decision.server` over the link topology, if asked and affordable.

        The transfer occupies every link on the union of both servers'
        paths (pages travel down one side of the tree and up the other)
        at the path's bottleneck bandwidth, charged against the same
        per-link ledgers payload transfers use — migration and uplink
        traffic genuinely contend. The destination's blocks are claimed
        up front so its pool can't oversubscribe while the pages are in
        flight; when they land (`KvMigrate`) the source frees and the
        request re-dispatches as a zero-re-prefill resume. False = the
        caller falls back to abandoning the pages (full re-prefill)."""
        j = decision.server
        src = req.kv_server
        spec = self.specs[j]
        if not decision.migrate_kv or spec.kv_blocks <= 0:
            return False
        need = spec.kv_blocks_needed(req.prompt_tokens, req.output_tokens)
        if need > spec.kv_blocks or self.kv_wait[j]:
            return False     # destination can't host the pages right now
        if self.kv_used[j] + need > spec.kv_blocks:
            self._prefix_reclaim(j, need, keep=req.prefix_id)
            if self.kv_used[j] + need > spec.kv_blocks:
                return False
        src_spec = self.specs[src]
        n_bytes = req.kv_blocks * src_spec.kv_block_tokens \
            * src_spec.kv_bytes_per_token()
        if n_bytes <= 0.0:
            return False     # nothing to ship (e.g. attention-free arch)
        path = self.topo.migration_path(src, j)
        bw = self.topo.migration_bandwidth(src, j, self._link_factors,
                                           self.link_scale)
        if not path or bw <= 0.0:
            return False
        self.kv_used[j] += need
        start = max(t, max(self.link_free[name] for name in path))
        end = start + n_bytes * 8.0 / bw
        self._book_links(path, end)
        st = self.states[src]
        # the source's radio pushes the pages; like payload transfers,
        # energy accrues over the whole window including the queue wait
        st.e_tx += (end - t) * src_spec.tx_power
        st.tx_busy_time += end - start
        self.n_kv_migrations += 1
        self.kv_migrated_bytes += n_bytes
        if self.trace is not None:
            self.trace.append(KIND_MIGRATE, req.sid, t, end, j,
                              req.class_id, 0,
                              (end - t) * src_spec.tx_power, n_bytes,
                              self.trace.intern(f"{src}->{j}"))
        self.loop.push(KvMigrate(end, request=req, decision=decision,
                                 context=(src, req.kv_blocks, j, need)))
        return True

    def on_kv_migrate(self, ev: KvMigrate) -> None:
        """Migrated pages landed: free them at the source, hand them to
        the request on the destination, and re-dispatch — the dispatch
        sees `kv_server == server`, so it books a decode-only resume with
        zero re-prefill (the destination's blocks were already claimed
        when the transfer started)."""
        req = ev.request
        src, src_blocks, j, need = ev.context
        self._prefix_unpin(req, ev.time)
        self._kv_free(src, src_blocks, ev.time)
        req.kv_server, req.kv_blocks = j, need
        self.dispatch(ev.time, req, ev.decision)

    def _tx_done(self, b: _Booking) -> None:
        st = self.states[b.j]
        # transmission energy accrues over the whole transfer window,
        # including the congestion queue (paper §2.3); for a preempted
        # continuation the window starts at the requeue instant — the
        # pre-preemption window was billed by the first TxDone. During the
        # transfer itself the radio draws tx_power × bw_share (a granted
        # slice lights up a slice of the link), so a sub-unit share's
        # *transfer* energy is share-invariant and only its queue window
        # still charges full power.
        st.e_tx += (b.ready - b.charge_from) * self.specs[b.j].tx_power \
            - (1.0 - b.alloc.bw_share) * b.tx_dur * self.specs[b.j].tx_power
        st.tx_busy_time += b.tx_dur

    def on_tx_done(self, ev: TxDone) -> None:
        self._tx_done(ev.context)

    def on_preempt(self, ev: Preempt) -> None:
        """Return the victim's lane and requeue its remaining work.

        Runs synchronously inside the preemptor's `place`, so the freed
        lane is visible before the preemptor's dispatch books it. The
        victim's booking rolls back only if it is still the last booking
        on its lane; partial decode already burned is charged as wasted
        inference energy, and the victim re-enters as a fresh Arrival
        carrying its remaining decode tokens.

        On a KV-modeled server the victim's pages survive the eviction by
        default (`ev.drop_kv` False): they stay allocated, and if the
        requeue lands back on this server the continuation skips prefill
        entirely. `drop_kv` frees them on the spot instead — preemption
        as *memory* relief — at the price of a full re-prefill wherever
        the victim resumes. Servers without a block pool keep the legacy
        semantics: KV is dropped with the lane and preemption is never
        free."""
        b = self._inflight.get(ev.victim)
        if b is None:
            return       # victim already finished (or never dispatched)
        t = ev.time
        if t < b.ready:
            # victim still in transit: its payload occupies the path links
            # and its TxDone will bill the transfer — aborting here would
            # leave ghost link occupancy and double-charge tx energy, so
            # only lane-resident (transfer-complete) victims are preempted
            return
        lanes = self.lane_free[b.j]
        if lanes[b.li] != b.finish:
            # a later booking already stacked onto the victim's lane:
            # cancelling would free no capacity (the stacked booking's
            # start was computed from the victim's finish), so refuse —
            # killing the victim here would be pure wasted work
            return
        del self._inflight[ev.victim]
        b.cancelled = True
        req = b.request
        spec = self.specs[b.j]
        st = self.states[b.j]
        lanes[b.li] = b.lane_prev if t <= b.begin else t
        e_waste = 0.0
        if t > b.begin:
            # wasted partial decode: the server burned real energy on it,
            # at the victim's allocated tier/share
            done = min(t, b.finish) - b.begin
            e_waste = spec.infer_energy(done, tier=b.alloc.freq_tier,
                                        lane_share=b.alloc.lane_share)
            st.e_infer += e_waste
            st.busy_time += done / spec.max_concurrency
            frac_left = max(b.finish - t, 0.0) / b.t_inf
            remaining = max(1, int(math.ceil(req.output_tokens * frac_left)))
        else:
            remaining = req.output_tokens
        if spec.kv_blocks > 0 and req.kv_blocks > 0:
            started = t > b.begin
            # a booking that never began holds prefilled pages only if it
            # was itself a resume (its KV survives from the earlier run)
            prefilled = started or b.kv_resumed
            if ev.drop_kv and ev.request is not None:
                # memory-pressure eviction: the blocks return *undrained*
                # and the preemptor (dispatched synchronously next, inside
                # the same `place`) gets first claim on them — that is the
                # whole point of the drop. Leftovers reach the kv_wait
                # FIFO at the next free event on this server.
                self.kv_used[b.j] -= req.kv_blocks
                req.kv_server, req.kv_blocks = -1, 0
                self._prefix_unpin(req, t)
                self._kv_express[ev.request.sid] = b.j
            elif ev.drop_kv or not prefilled:
                self._prefix_unpin(req, t)
                self._kv_free(b.j, req.kv_blocks, t)
                req.kv_server, req.kv_blocks = -1, 0
            if started:
                self.n_kv_evictions += 1
        req.output_tokens = remaining
        req.preemptions += 1
        self.n_preempted += 1
        if self.trace is not None:
            # span covers the wasted decode window (a point at t when the
            # victim had not yet begun); value = tokens left to requeue
            self.trace.append(KIND_PREEMPT, req.sid,
                              b.begin if t > b.begin else t, t, b.j,
                              req.class_id, b.alloc.freq_tier, e_waste,
                              float(remaining), b.li)
        self.loop.push(Arrival(t, requests=(req,)))

    def _infer_done(self, b: _Booking, finish: float) -> None:
        if b.cancelled:
            return                       # preempted: the requeue completes
        req = b.request
        self._inflight.pop(req.sid, None)
        spec = self.specs[b.j]
        st = self.states[b.j]
        st.busy_time += b.t_inf / spec.max_concurrency
        e_inf = spec.infer_energy(b.t_inf, tier=b.alloc.freq_tier,
                                  lane_share=b.alloc.lane_share)
        st.e_infer += e_inf
        st.tokens_out += req.output_tokens
        st.served += 1
        if spec.kv_blocks > 0 and req.kv_blocks > 0:
            blocks, req.kv_server, req.kv_blocks = req.kv_blocks, -1, 0
            self._prefix_unpin(req, finish)
            self._kv_free(b.j, blocks, finish)
        if b.kv_resumed:
            # credited at completion, not dispatch: a resume preempted
            # again before it ran must not bank phantom savings
            self.kv_prefill_tokens_saved += req.prompt_tokens
        elif b.prefix_saved:
            # same late-credit rule for shared-prefix hits
            self.kv_prefill_tokens_saved += b.prefix_saved
            self.n_prefix_hits += 1
        req.finish = finish
        req.server = b.j
        proc = finish - req.arrival
        out = Outcome(
            server=b.j, tx_time=(b.ready - req.arrival),
            queue_time=max(b.begin - b.ready, 0.0), infer_time=b.t_inf,
            finish=finish, processing_time=proc,
            success=proc <= req.deadline,
            energy=b.tx_dur * spec.tx_power * b.alloc.bw_share + e_inf)
        self.outcomes.append(out)
        if self.trace is not None:
            self._trace_complete(req, b.j, b.li, b.alloc.freq_tier,
                                 b.ready, b.begin, finish,
                                 b.tx_dur * spec.tx_power
                                 * b.alloc.bw_share, e_inf, out.success)
        self.policy.feedback(req, out)

    def on_infer_done(self, ev: InferDone) -> None:
        self._infer_done(ev.context, ev.time)

    # ---------------- arrival cursor & fast drain ------------------------
    def seed_arrivals(self, services: List[ServiceRequest]) -> None:
        """Walk `services` (sorted by arrival) with a cursor instead of
        pre-pushing one Arrival event each. Virtual sequence numbers
        0..N-1 are reserved for the cursor so every equal-time tie-break
        (seeded vs requeued arrivals, scenario events) orders exactly as
        the seeded-heap reference core."""
        self._services = services
        self.loop._seq = len(services)

    def _cursor_arrival(self, t: float, req: ServiceRequest) -> None:
        """Inlined single-request `on_arrival` (same semantics as
        `Runtime.on_arrival` + `drive_slot` for a 1-tuple; `drain` has
        already advanced the clock)."""
        view = self.build_view(t)
        d = self.policy.assign(req, view)
        if d.admit:
            view.apply(req, d)
            if d.preempt_victim is None and d.defer_until <= t:
                if self.trace is not None and req.preemptions:
                    self._trace_decision(t, req, d)
                self.dispatch(t, req, d)
                return
        self.place(t, req, d)

    def drain(self, max_events: int = 10_000_000) -> None:
        """Merge the arrival cursor with the event heap; stop when only
        housekeeping (BandwidthChange) events remain."""
        services = self._services if self._services is not None else []
        n = len(services)
        i = 0
        clock = self.clock
        loop = self.loop
        heap = loop._heap
        pop = heapq.heappop
        cursor_arrival = self._cursor_arrival
        tx_done = self._tx_done
        infer_done = self._infer_done
        handled = 0
        while handled < max_events:
            handled += 1
            if i < n:
                r = services[i]
                ta = r.arrival
                if heap:
                    h0 = heap[0]
                    t0 = h0[0]
                    take_heap = t0 < ta or (
                        t0 == ta and (h0[1] < 5 or (h0[1] == 5
                                                    and h0[2] < i)))
                else:
                    take_heap = False
                if not take_heap:
                    i += 1
                    if ta > clock:
                        clock = ta
                        self.clock = ta
                    cursor_arrival(ta, r)
                    continue
            elif not heap or loop.n_work == 0:
                return
            item = pop(heap)
            ev = item[3]
            t = item[0]
            if t > clock:
                clock = t
                self.clock = t
            cls = ev.__class__
            if cls is _Booking:
                loop.n_work -= 1
                if item[1] == 3:
                    tx_done(ev)
                else:
                    infer_done(ev, t)
            elif cls is BandwidthChange:
                self.on_bandwidth_change(ev)
            else:
                loop.n_work -= 1
                self.handle(ev)
        raise RuntimeError(f"runtime did not drain in {max_events} events")


# ---------------------------------------------------------------------------
# Simulator — seeds the event streams and aggregates results
# ---------------------------------------------------------------------------


class Simulator:
    """Event-driven edge-cloud simulator. `bw_interval` is the
    fluctuating bandwidth model's resample cadence (and the pseudo-slot
    length of `Runtime.slot_index`).

    `slot` is retired: the simulator always runs event-driven. The
    parameter is kept so legacy call sites fail with a clear message —
    any numeric value raises, `slot=None` is accepted and ignored.

    `topology` is the network (`repro_torch.cluster.network.LinkTopology`);
    `None` builds the degenerate one-link-per-server topology around
    `bandwidth`, which reproduces the legacy per-server model bit-exactly
    (the frozen golden tests pin this)."""

    def __init__(self, specs: Sequence[ServerSpec],
                 bandwidth: Optional[BandwidthModel] = None,
                 slot: None = None, seed: int = 0,
                 bw_interval: float = 0.5,
                 topology: Optional[LinkTopology] = None,
                 core: str = "array"):
        if slot is not None:
            raise ValueError(
                f"slotted mode was removed: Simulator always runs "
                f"event-driven now, so slot={slot!r} has no "
                f"implementation. Drop the slot= argument (slot=None is "
                f"accepted for compatibility); quantized-slot goldens "
                f"were migrated to event-mode goldens.")
        if core not in ("array", "reference"):
            raise ValueError(f"core must be 'array' or 'reference', "
                             f"got {core!r}")
        self.core = core
        self.specs = list(specs)
        self.bandwidth = bandwidth or BandwidthModel()
        self.topology = topology \
            or LinkTopology.degenerate(self.specs, self.bandwidth)
        if self.topology.n_servers != len(self.specs):
            raise ValueError(
                f"topology routes {self.topology.n_servers} servers but the "
                f"testbed has {len(self.specs)}")
        self.slot = slot
        self.bw_interval = bw_interval
        rng = np.random.default_rng(seed)
        # hidden per-(service-class, server) efficiency (unknown to
        # schedulers): the paper's "diversity of task requirements" — e.g.
        # long-context classes stress small-RAM edges, chatty classes hit
        # cloud batching pathologies. Only per-class learners can adapt.
        from repro_torch.cluster.workload import N_CLASSES
        self.efficiency = rng.uniform(0.7, 1.0, (N_CLASSES, len(specs)))
        self.noise_rng = np.random.default_rng(seed + 1)
        self._noise_buf: List[float] = []
        self._noise_i = 0

    def run(self, services: List[ServiceRequest], scheduler,
            scenario: Union[Scenario, str, None] = None,
            trace=None) -> SimResult:
        """Simulate `services` under `scheduler` (a `SchedulingPolicy`).
        `scenario` (instance or registered name) may inject extra
        bandwidth events; arrival shaping happens in the workload
        generator. `trace` (a `repro_torch.obs.TraceRecorder`) records every
        request's lifecycle spans; the default None keeps the hot path
        untouched, and a traced run is result-bit-identical to an
        untraced one (golden-tested)."""
        policy = ensure_policy(scheduler)
        if isinstance(scenario, str):
            scenario = make_scenario(scenario)

        services = sorted(services, key=lambda r: r.arrival)
        for r in services:
            r.class_id = classify(r)
            r.finish = -1.0
            r.server = -1
            r.preemptions = 0
            # repro-check: orphan(kv_used) — pre-run reset of the claim
            # record; no pages are charged before the first dispatch
            r.kv_server = -1
            r.kv_blocks = 0
        if not services:
            return SimResult.empty(policy.name, len(self.specs))

        if self.core == "reference":
            from repro_torch.cluster.reference_sim import _ReferenceEventRuntime
            rt: _SimRuntimeBase = _ReferenceEventRuntime(self, policy,
                                                         trace=trace)
            for r in services:
                rt.loop.push(Arrival(r.arrival, requests=(r,)))
        else:
            rt = _EventSimRuntime(self, policy, trace=trace)
            rt.seed_arrivals(services)
        if scenario is not None:
            horizon = services[-1].arrival
            for ev in scenario.bandwidth_events(horizon, len(self.specs)):
                rt.loop.push(ev)
        rt.drain()
        return self._aggregate(policy.name, services, rt)

    def _aggregate(self, name: str, services: List[ServiceRequest],
                   rt: _SimRuntimeBase) -> SimResult:
        outcomes, states = rt.outcomes, rt.states
        completed = [o for o in outcomes if not o.rejected]
        if not completed:
            res = SimResult.empty(name, len(self.specs))
            res.n_services = len(services)
            res.n_rejected = rt.n_rejected
            res.n_preempted = rt.n_preempted
            res.n_kv_evictions = rt.n_kv_evictions
            res.kv_prefill_tokens_saved = rt.kv_prefill_tokens_saved
            res.n_prefix_hits = rt.n_prefix_hits
            res.n_kv_orphaned = rt.n_kv_orphaned
            res.n_kv_migrations = rt.n_kv_migrations
            res.kv_migrated_bytes = rt.kv_migrated_bytes
            res.metrics = self._finalize_metrics(res, rt, [])
            return res
        makespan = max(o.finish for o in completed)
        for st in states:
            st.finalize_idle(makespan)

        # success counts every service (a rejection is an SLO miss);
        # processing-time stats describe the admitted ones
        times = np.array([o.processing_time for o in completed])
        succ = np.array([o.success for o in outcomes])
        adm_succ = np.array([o.success for o in completed])
        tokens = sum(r.prompt_tokens + r.output_tokens for r in services
                     if r.finish >= 0)
        res = SimResult(
            name=name,
            n_services=len(services),
            success_rate=float(np.mean(succ)),
            avg_processing_time=float(np.mean(times)),
            p95_processing_time=float(np.percentile(times, 95)),
            throughput_tokens_per_s=tokens / makespan,
            makespan=float(makespan),
            e_tx=sum(st.e_tx for st in states),
            e_infer=sum(st.e_infer for st in states),
            e_idle=sum(st.e_idle for st in states),
            per_server_served=[st.served for st in states],
            n_rejected=rt.n_rejected,
            n_preempted=rt.n_preempted,
            admitted_success_rate=float(np.mean(adm_succ)),
            n_kv_evictions=rt.n_kv_evictions,
            kv_prefill_tokens_saved=rt.kv_prefill_tokens_saved,
            n_prefix_hits=rt.n_prefix_hits,
            n_kv_orphaned=rt.n_kv_orphaned,
            n_kv_migrations=rt.n_kv_migrations,
            kv_migrated_bytes=rt.kv_migrated_bytes,
            served_tokens=tokens,
        )
        res.metrics = self._finalize_metrics(res, rt, times)
        return res

    @staticmethod
    def _finalize_metrics(res: SimResult, rt: _SimRuntimeBase, times):
        """Fold the run-level aggregates into the runtime's live
        registry (the hot-path counters are already in it via
        `counter_attr`), producing the registry `SimResult.metrics`
        exposes. Labeled per-server counters and the processing-time
        histogram are derived here, once per run, off the hot path."""
        m = rt.metrics
        m.put_scalar("n_served", sum(res.per_server_served))
        m.put_scalar("served_tokens", res.served_tokens)
        for j, served in enumerate(res.per_server_served):
            m.inc("per_server_served", served, server=j)
        m.set_gauge("success_rate", res.success_rate)
        m.set_gauge("admitted_success_rate", res.admitted_success_rate)
        m.set_gauge("avg_processing_time", res.avg_processing_time)
        m.set_gauge("p95_processing_time", res.p95_processing_time)
        m.set_gauge("throughput_tokens_per_s",
                    res.throughput_tokens_per_s)
        m.set_gauge("makespan", res.makespan)
        m.set_gauge("e_tx", res.e_tx)
        m.set_gauge("e_infer", res.e_infer)
        m.set_gauge("e_idle", res.e_idle)
        m.register_histogram("processing_time_s",
                             (0.5, 1.0, 2.0, 4.0, 8.0, 16.0))
        if len(times):
            m.observe_many("processing_time_s", times)
        return m

    # ------------------------------------------------------------------
    # Shared physics: both cores realize requests with exactly these
    # draws/formulas, so array-vs-reference comparisons measure the
    # *scheduling* semantics, never drifting cost models.
    # ------------------------------------------------------------------
    def _draw_infer(self, req: ServiceRequest, j: int,
                    resume: bool = False,
                    alloc: Optional[Allocation] = None,
                    prefix_tokens: int = 0) -> float:
        """Realized inference time: nominal / hidden efficiency × noise.
        Consumes one noise draw — call once per realized request.
        `resume` drops the prefill term: the request's KV pages survived
        its eviction on this server, so only the remaining decode runs.
        `prefix_tokens` drops just that many prompt tokens from the
        prefill term — the server already holds their KV as a shared
        prefix. `alloc` stretches the window by 1/(freq × lane_share) —
        the DVFS tier slows the clock, a sub-unit lane share slices the
        lane."""
        # draws are buffered: one bulk `lognormal(size=4096)` consumes the
        # same RNG stream as 4096 sequential scalar draws (verified
        # bit-identical, including across refills), at a fraction of the
        # per-call overhead. The buffer lives on the Simulator, so draw
        # sequences across multiple `run` calls also match the scalar path.
        i = self._noise_i
        buf = self._noise_buf
        if i >= len(buf):
            buf = self._noise_buf = \
                self.noise_rng.lognormal(0.0, 0.08, 4096).tolist()
            i = 0
        noise = buf[i]
        self._noise_i = i + 1
        nominal = (self.specs[j].decode_time(req.output_tokens) if resume
                   else self.specs[j].service_time(
                       req.prompt_tokens - prefix_tokens,
                       req.output_tokens))
        t_inf = (nominal / self.efficiency[req.class_id, j]) * noise
        if alloc is not None:
            t_inf /= alloc.freq(self.specs[j]) * alloc.lane_share
        return t_inf
