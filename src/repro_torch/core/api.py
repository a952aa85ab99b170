"""The unified scheduling contract shared by the simulator and live server.

One protocol, two runtimes. A scheduler is a `SchedulingPolicy`: per
request it returns a `Decision` (server, a resource `Allocation`, optional
dispatch deferral, an inference-time correction, and per-constraint slack
diagnostics); after the request completes it receives the realized
`feedback`. The *runtime* — the discrete-event `Simulator` or the live
`PerLLMServer` — owns the `ClusterView` it exposes, applies each Decision's
residual accounting via `ClusterView.commit`, and applies the deferral.
Policies never mutate requests or runtime state directly.

Scheduling *and* resource allocation are one decision (paper Eq. 1 jointly
minimizes energy over both): a `Decision` names not just *where* a request
runs but *how* — the server's DVFS frequency tier and the lane/uplink
shares granted to it. Runtimes scale realized time, energy and ledger
bookings by the allocation; the default `Allocation()` is the nominal tier
with full shares and reproduces the placement-only behavior bit-exactly.

Layering: this module is the bottom of the scheduling stack. It imports
nothing from `repro_torch.cluster`; server specs and requests are structural
(anything with `bandwidth`, `max_concurrency`, `service_time`, …), so both
the simulated testbed and the live engine fleet satisfy it.

Policies register themselves by name (`@register_policy("perllm")`) and are
constructed with `make_policy(name, n_servers, **kw)` — benchmarks,
examples, and the serve CLI all go through the registry.

The pre-PR-1 `SchedulerBase` batch protocol and its `as_policy` shim are
retired: nothing in-tree (or in the docs) subclasses it anymore, and
`drive_slot` drives `SchedulingPolicy.assign` only.
"""
from __future__ import annotations

import dataclasses
from typing import (
    TYPE_CHECKING, Any, Callable, Dict, List, Optional, Sequence, Tuple,
)

import numpy as np

if TYPE_CHECKING:  # type-only: keeps core.api free of upward imports
    from repro_torch.core.constraints import ConstraintSlacks


# ---------------------------------------------------------------------------
# Allocation — how much of the chosen server a request gets
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Allocation:
    """Per-request resource vector carried by a `Decision`.

    freq_tier   index into the server's `spec.freq_tiers` DVFS table;
                -1 selects the nominal tier (frequency 1.0) regardless of
                the table, so allocation-blind policies never need to know
                a server's tier count. At frequency f, inference time
                scales as 1/f and dynamic power as f³ — so energy *per
                token* scales as f²: a slow tier that still meets the
                deadline is strictly cheaper.
    lane_share  fraction of one batch lane's compute granted, in (0, 1]; a
                share s stretches inference by 1/s while drawing s of the
                lane's dynamic power (per-request energy is
                share-invariant — the share is a latency/capacity knob)
    bw_share    fraction of the (factor-adjusted) uplink granted to the
                transfer, in (0, 1]; stretches the transfer by 1/s while
                the radio draws s of `tx_power`

    Shares use exclusive-window semantics: the lane/link is booked for the
    stretched duration, so concurrently committed shares can never
    oversubscribe a resource (property-tested in
    `tests/test_allocation.py`).
    """

    freq_tier: int = -1
    lane_share: float = 1.0
    bw_share: float = 1.0

    def __post_init__(self):
        if not (0.0 < self.lane_share <= 1.0):
            raise ValueError(f"lane_share must be in (0, 1], got "
                             f"{self.lane_share}")
        if not (0.0 < self.bw_share <= 1.0):
            raise ValueError(f"bw_share must be in (0, 1], got "
                             f"{self.bw_share}")

    def freq(self, spec) -> float:
        """Resolved frequency on `spec` (1.0 for the nominal tier)."""
        if self.freq_tier < 0:
            return 1.0
        return float(spec.freq_tiers[self.freq_tier])


#: The nominal allocation: nominal frequency tier, full lane and uplink.
NOMINAL = Allocation()


# ---------------------------------------------------------------------------
# Decision — what a policy returns for one request
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, slots=True)
class Decision:
    """One request's placement + allocation, returned by
    `SchedulingPolicy.assign`.

    server          index of the chosen server (C4: exactly one per
                    request; for a rejection it names the server the
                    policy *would* have used — learners need an arm index)
    alloc           the resource `Allocation` granted on that server
                    (DVFS tier, lane share, uplink share); the default is
                    nominal-everything, which runtimes honor bit-exactly
                    as the placement-only behavior
    defer_until     earliest dispatch time; 0.0 = dispatch on arrival (used
                    by deferred-batching policies such as FineInfer)
    infer_scale     multiplicative correction the policy has learned for
                    the nominal inference-time model on this server; the
                    runtime commits lane residuals scaled by it (applied
                    on top of the allocation's 1/(f·lane_share) stretch)
    slacks          per-constraint slack diagnostics (C1/C2/C3/C5) at
                    decision time, evaluated *at the chosen allocation* —
                    observational
    admit           False = admission control sheds the request: the
                    runtime emits a rejected Outcome (SLO-violation cost,
                    zero server energy) instead of queueing it
    preempt_victim  sid of a running request whose batch lane should be
                    returned before this request dispatches; the victim's
                    remaining decode tokens are requeued as a new Arrival
    preempt_drop_kv KV-resume info carried with the preemption: False
                    (default) keeps the victim's KV pages resident on its
                    server, so a same-server requeue resumes decode with
                    zero re-prefill; True frees the pages immediately —
                    the right call when the preemption is relieving KV
                    *memory* exhaustion rather than reclaiming a lane
                    (ignored on servers that don't model KV)
    migrate_kv      the request holds preserved KV pages on another server
                    (`req.kv_server`) and the policy wants them *shipped*
                    to `server` over the link topology instead of
                    re-prefilled: the runtime books the transfer bytes on
                    every link of the migration path and the request
                    resumes decode on `server` with zero re-prefill once
                    the `KvMigrate` event lands. Ignored when the request
                    holds no pages, when `server` IS the KV home (a plain
                    resume is free), or when the destination cannot host
                    the pages (the legacy orphan-and-re-prefill path runs
                    instead). Event-driven runtimes only.
    """

    server: int
    alloc: Allocation = NOMINAL
    defer_until: float = 0.0
    infer_scale: float = 1.0
    slacks: Optional["ConstraintSlacks"] = None
    admit: bool = True
    preempt_victim: Optional[int] = None
    preempt_drop_kv: bool = False
    migrate_kv: bool = False


# ---------------------------------------------------------------------------
# ClusterView — the one observation object both runtimes build
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RunningTask:
    """One in-flight request, as exposed to preemption-capable policies.

    `finish_est` is the runtime's current completion estimate for the
    booked lane; `deadline_at` is the absolute SLO instant
    (arrival + deadline). A task with `finish_est > deadline_at` is doomed
    — preempting it frees its lane without costing an extra SLO miss.
    `tier` is the DVFS tier the task is running at (-1 = nominal).
    """

    sid: int
    server: int
    class_id: int
    deadline_at: float
    begin: float        # when its lane booking starts (may be in the past)
    finish_est: float
    tier: int = -1

    @property
    def doomed(self) -> bool:
        return self.finish_est > self.deadline_at


@dataclasses.dataclass
class ClusterView:
    """What a policy may observe when assigning one slot's arrivals.

    Built by the runtime from *real* state: per-server uplink occupancy,
    batch-lane occupancy, and the current bandwidth factor of each link.
    Mutable residuals (`uplink_free_at`, `lane_free`) are advanced by the
    runtime's `commit` after each Decision, so later requests in the same
    slot see the reduced capacity (the combinatorial super-arm accounting).
    Hidden runtime state (efficiency, noise) is NOT here.

    Per-server `bw_factor` / `uplink_free_at` are *path-effective* values
    when the runtime models a `LinkTopology` (bottleneck bandwidth over
    the server's link path, latest path-link backlog), so the nominal
    predictors work unchanged. Topology-aware policies can additionally
    read the per-link fields:

    link_bw     observed bits/s per named link (capacity × factor × scale)
    link_queue  seconds of serialized backlog per named link
    paths       link names each server's ingress traffic traverses
    running     per-server in-flight tasks (`RunningTask`, including the
                tier each runs at) — what a preemption-capable policy may
                name as `preempt_victim`; None when the runtime does not
                support preemption

    KV memory — the binding resource for LLM decode on edge hardware — is
    first-class when the runtime models it (paged engines / `ServerSpec`s
    with a block pool):

    kv_free_blocks   free KV-cache blocks per server right now
    kv_total_blocks  each server's block-pool size; an entry of 0 means
                     that server does not model KV (its kv_free_blocks
                     entry is meaningless and the KV constraint is vacuous)
    kv_prefix_tokens per-server map of shared-prefix pool id ->
                     resident *ready* prefix tokens: how much of that
                     system prompt's KV is already prefilled on the
                     server. `prefix_hit_tokens(req, j)` turns it into
                     the prefill tokens request `req` would skip on j;
                     None when the runtime models no prefix sharing.

    Allocation state — the committed-share ledger IS `uplink_free_at` /
    `lane_free` (shares use exclusive stretched-window bookings, so a
    resource is never >100% committed); `tier_load`, when the runtime
    models multiple DVFS tiers, additionally splits each server's
    committed lane-seconds by frequency tier (advanced by `commit`), so
    tier-aware policies can see how a server's capacity is currently
    paced.
    """

    t: float
    specs: Sequence[Any]            # ServerSpec-shaped objects
    bw_factor: List[float]
    uplink_free_at: List[float]
    lane_free: List[List[float]]
    link_bw: Optional[Dict[str, float]] = None
    link_queue: Optional[Dict[str, float]] = None
    paths: Optional[Sequence[Sequence[str]]] = None
    running: Optional[List[List[RunningTask]]] = None
    kv_free_blocks: Optional[List[int]] = None
    kv_total_blocks: Optional[List[int]] = None
    kv_prefix_tokens: Optional[List[Dict[int, int]]] = None
    tier_load: Optional[List[List[float]]] = None

    @property
    def n_servers(self) -> int:
        return len(self.specs)

    # ---------------- KV affinity helpers --------------------------------
    def prefix_hit_tokens(self, req, j: int) -> int:
        """Prefill tokens `req` would skip on server j thanks to resident
        shared-prefix pages (0 without prefix modeling or a match).

        Clipped to full blocks of the request's *own* shared prefix and
        to strictly less than its prompt (>= 1 token must still prefill
        to produce logits)."""
        if self.kv_prefix_tokens is None:
            return 0
        pid = getattr(req, "prefix_id", -1)
        if pid < 0:
            return 0
        resident = self.kv_prefix_tokens[j].get(pid, 0)
        if resident <= 0:
            return 0
        bt = getattr(self.specs[j], "kv_block_tokens", 0)
        if bt <= 0:
            return 0
        own = min(getattr(req, "prefix_tokens", 0), req.prompt_tokens - 1)
        return min(resident, (own // bt) * bt)

    def kv_migration_s(self, req, dst: int) -> Optional[float]:
        """Predicted seconds to ship `req`'s preserved KV pages from
        their current home to server `dst` over the link topology —
        the migration-cost slack policies weigh against re-prefill.
        None when the request holds no pages or links aren't modeled."""
        src = getattr(req, "kv_server", -1)
        n_blocks = getattr(req, "kv_blocks", 0)
        if src < 0 or n_blocks <= 0 or src == dst:
            return None
        if self.link_bw is None or self.paths is None:
            return None
        src_spec = self.specs[src]
        bt = getattr(src_spec, "kv_block_tokens", 0)
        per_tok = getattr(src_spec, "kv_bytes_per_token", None)
        if bt <= 0 or per_tok is None:
            return None
        path: List[str] = []
        for name in list(self.paths[src]) + list(self.paths[dst]):
            if name not in path:
                path.append(name)
        bw = min(self.link_bw[name] for name in path)
        if bw <= 0:
            return None
        queue = max((self.link_queue or {}).get(name, 0.0)
                    for name in path)
        bits = n_blocks * bt * per_tok() * 8.0
        return queue + bits / bw

    def n_tiers(self, j: int) -> int:
        """Size of server j's DVFS table (1 when the spec predates tiers)."""
        return len(getattr(self.specs[j], "freq_tiers", (1.0,)))

    # ---------------- nominal predictors (no hidden factors) -------------
    def predict_tx(self, req, j: int,
                   alloc: Optional[Allocation] = None) -> float:
        spec = self.specs[j]
        share = 1.0 if alloc is None else alloc.bw_share
        start = max(self.t, self.uplink_free_at[j])
        dur = req.payload_bytes * 8.0 \
            / (spec.bandwidth * self.bw_factor[j] * share)
        return (start - self.t) + dur

    def predict_queue(self, req, j: int,
                      alloc: Optional[Allocation] = None) -> float:
        ready = self.t + self.predict_tx(req, j, alloc)
        lane = min(self.lane_free[j])
        return max(lane - ready, 0.0)

    def predict_infer(self, req, j: int,
                      alloc: Optional[Allocation] = None) -> float:
        nominal = self.specs[j].service_time(req.prompt_tokens,
                                             req.output_tokens)
        if alloc is None:
            return nominal
        return nominal / (alloc.freq(self.specs[j]) * alloc.lane_share)

    def predict_total(self, req, j: int,
                      alloc: Optional[Allocation] = None) -> float:
        return (self.predict_tx(req, j, alloc)
                + self.predict_queue(req, j, alloc)
                + self.predict_infer(req, j, alloc))

    # ---------------- residual accounting (runtime-applied) --------------
    def commit(self, req, j: int, infer_scale: float = 1.0,
               alloc: Optional[Allocation] = None) -> None:
        """Update residuals as if req were placed on j under `alloc`.

        Called by the runtime (`drive_slot`), not by policies — that is what
        guarantees C2/C3 accounting cannot be silently skipped. Allocation
        shares book their *stretched* windows exclusively (a half-share
        transfer occupies the uplink twice as long), so the committed-share
        ledger can never oversubscribe; a non-nominal tier books the
        slowed lane window and is tallied in `tier_load`."""
        spec = self.specs[j]
        share = 1.0 if alloc is None else alloc.bw_share
        start = max(self.t, self.uplink_free_at[j])
        dur = req.payload_bytes * 8.0 \
            / (spec.bandwidth * self.bw_factor[j] * share)
        self.uplink_free_at[j] = start + dur
        ready = start + dur
        lanes = self.lane_free[j]
        # first-occurrence min, same lane np.argmin picked; a plain loop
        # skips the list->ndarray round-trip that dominated this method
        li = 0
        lane_min = lanes[0]
        for k in range(1, len(lanes)):
            if lanes[k] < lane_min:
                li = k
                lane_min = lanes[k]
        begin = max(ready, lane_min)
        # predict_infer, inlined (hot path: once per admitted request)
        nominal = spec.service_time(req.prompt_tokens, req.output_tokens)
        if alloc is not None:
            nominal = nominal / (alloc.freq(spec) * alloc.lane_share)
        booked = nominal * infer_scale
        lanes[li] = begin + booked
        if self.tier_load is not None:
            tier = -1 if alloc is None else alloc.freq_tier
            if tier < 0:
                tier = getattr(spec, "nominal_tier", 0)
            self.tier_load[j][tier] += booked

    def apply(self, req, decision: Decision) -> None:
        """Commit one Decision's residuals (placement + allocation)."""
        self.commit(req, decision.server, infer_scale=decision.infer_scale,
                    alloc=decision.alloc)


# ---------------------------------------------------------------------------
# SchedulingPolicy — the contract
# ---------------------------------------------------------------------------


class SchedulingPolicy:
    """Per-request scheduling contract.

    Subclasses implement `assign` (pure with respect to the view: no
    `commit`, no request mutation) and optionally `feedback`.
    """

    name = "policy"

    def assign(self, request, view: ClusterView) -> Decision:
        raise NotImplementedError

    def feedback(self, request, outcome) -> None:
        """Realized outcome for a previously assigned request."""


def ensure_policy(policy) -> SchedulingPolicy:
    """Validate that `policy` implements the `SchedulingPolicy` contract.

    The legacy batch `SchedulerBase` protocol is retired; anything that
    only offers `.schedule` gets a migration-pointing TypeError instead of
    a silent shim. Duck-typed policies must provide the *whole* runtime
    surface (`assign`, `feedback`, `name`) so an incomplete object fails
    here, at run start, rather than mid-simulation at its first completed
    request."""
    if isinstance(policy, SchedulingPolicy):
        return policy
    if callable(getattr(policy, "assign", None)) \
            and callable(getattr(policy, "feedback", None)) \
            and isinstance(getattr(policy, "name", None), str):
        return policy
    raise TypeError(
        f"{type(policy).__name__} does not implement SchedulingPolicy "
        "(.assign/.feedback/.name); the legacy SchedulerBase batch "
        "protocol was removed — see docs/scheduling_api.md for the "
        "migration recipe")


# ---------------------------------------------------------------------------
# Runtime driver — the one place Decisions are applied
# ---------------------------------------------------------------------------


def drive_slot(policy, arrivals: Sequence[Any], view: ClusterView,
               t_slot: int = 0) -> List[Decision]:
    """Ask `policy` for one Decision per arrival and apply each to `view`.

    This is the runtime side of the contract: the policy only *returns*
    Decisions; residual accounting (`view.commit`) happens here, in arrival
    order, so within-slot C2/C3 consumption is always recorded.
    """
    policy = ensure_policy(policy)
    decisions: List[Decision] = []
    for req in arrivals:
        d = policy.assign(req, view)
        if d.admit:
            # rejected requests consume no capacity: no residual commit
            view.apply(req, d)
        decisions.append(d)
    return decisions


# ---------------------------------------------------------------------------
# Policy registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Tuple[str, Callable[..., SchedulingPolicy]]] = {}


def _normalize(name: str) -> str:
    return "".join(c for c in name.lower() if c.isalnum())


def register_policy(name: str, factory: Optional[Callable] = None):
    """Register a policy factory under `name` (case/punctuation-insensitive).

    Usable as a decorator on a `SchedulingPolicy` subclass::

        @register_policy("perllm")
        class PerLLMScheduler(SchedulingPolicy): ...

    or directly with any callable `factory(n_servers, **kw)`.
    """
    def _register(fac):
        key = _normalize(name)
        _REGISTRY[key] = (name, fac)
        return fac

    return _register(factory) if factory is not None else _register


def available_policies() -> List[str]:
    """Canonical names of every registered policy, sorted."""
    _load_builtin_policies()
    return sorted(display for display, _ in _REGISTRY.values())


def make_policy(name: str, n_servers: int, **kwargs) -> SchedulingPolicy:
    """Construct a registered policy by name.

    Lookup ignores case and punctuation, so "PerLLM", "perllm" and
    "rewardless-guidance" all resolve. Raises KeyError (listing the known
    names) for anything unregistered."""
    _load_builtin_policies()
    key = _normalize(name)
    if key not in _REGISTRY:
        raise KeyError(
            f"unknown scheduling policy {name!r}; available: "
            + ", ".join(available_policies()))
    _, factory = _REGISTRY[key]
    return factory(n_servers, **kwargs)


def _load_builtin_policies() -> None:
    """Import the modules whose import side effect registers the built-ins."""
    import repro_torch.core.baselines  # noqa: F401
    import repro_torch.core.scheduler  # noqa: F401


__all__ = [
    "Allocation", "ClusterView", "Decision", "NOMINAL", "RunningTask",
    "SchedulingPolicy", "available_policies", "drive_slot", "ensure_policy",
    "make_policy", "register_policy",
]
