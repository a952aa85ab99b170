"""PerLLMServer: the paper's system as a deployable service object.

Owns N `ServingEngine`s (the edge/cloud fleet), a scheduling policy and a
cluster spec; callers `submit()` requests with deadlines and `step()` the
service. Scheduling decisions route requests to a concrete engine, real
prefill/decode runs there, and realized latencies feed the learner — the
full loop of Fig. 3 in one class.

The server is a `repro_torch.core.runtime.Runtime`: the same event loop that
drives the simulator drives the fleet. Each submission becomes an `Arrival`
event; routing builds a *fresh* `ClusterView` at the arrival's timestamp
from real state — persistent uplink occupancy, the link bandwidth model's
current factor, and per-engine batch-lane occupancy derived from each
active request's **actual remaining decode tokens** (plus nominal bookings
for queued/in-flight work). Transmission completes as a `TxDone` event that
hands the request to the engine; each engine advances on its own
`InferStart` tick cadence (one real `ServingEngine.step` per tick, costing
that server's analytic per-step latency) instead of a fleet-wide lock-step
clock, so a fast edge is never held hostage to the cloud's step time.
Realized completions report the true transmission/queue/inference split and
energy from the realized inference window, so the live learner's feedback
matches the simulator's semantics.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.cluster.network import BandwidthModel, LinkStateMixin, LinkTopology
from repro_torch.cluster.server import ServerSpec
from repro_torch.cluster.simulator import Outcome, rejected_outcome
from repro_torch.cluster.workload import ServiceRequest, classify
from repro_torch.core.api import NOMINAL, ClusterView, Decision, RunningTask
from repro_torch.core.runtime import (
    Arrival, BandwidthChange, InferStart, KvMigrate, Preempt, Reject,
    Runtime, TxDone,
)
from repro_torch.core.scheduler import PerLLMScheduler
from repro_torch.obs.metrics import MetricsRegistry, counter_attr, with_aliases
from repro_torch.obs.trace import (
    KIND_ARRIVAL, KIND_DECISION, KIND_MIGRATE, KIND_PREEMPT,
    KIND_REJECT, KIND_RESUME,
)
from repro_torch.serving.engine import Request, ServingEngine


@dataclasses.dataclass
class ServedRequest:
    service: ServiceRequest
    engine_req: Optional[Request] = None
    server: int = -1
    submitted_clock: float = 0.0
    done_clock: float = -1.0
    decision: Optional[Decision] = None
    tx_time: float = 0.0          # arrival -> uplink transfer complete
    tx_dur: float = 0.0           # pure transfer duration (energy basis)
    dispatch_clock: float = -1.0  # entered the engine (TxDone)
    admit_clock: float = -1.0     # admitted to a batch lane (prefill start)
    # KV-preserving preemption: (server, evicted engine Request) whose
    # pages + snapshot survive on that engine until rerouting resolves
    evicted: Optional[tuple] = None

    @property
    def done(self) -> bool:
        return self.done_clock >= 0

    @property
    def latency(self) -> float:
        return self.done_clock - self.submitted_clock if self.done else -1.0

    @property
    def met_deadline(self) -> bool:
        return self.done and self.latency <= self.service.deadline


class PerLLMServer(Runtime, LinkStateMixin):
    # fleet counters live in the metrics registry (one canonical key
    # namespace with SimResult.stats()); `+= 1` call sites are unchanged
    n_preempted = counter_attr("n_preempted")
    n_kv_migrations = counter_attr("n_kv_migrations")
    kv_migrated_bytes = counter_attr("kv_migrated_bytes")

    def __init__(self, specs: Sequence[ServerSpec],
                 engines: Sequence[ServingEngine],
                 scheduler=None, slot: float = 0.5,
                 bandwidth: Optional[BandwidthModel] = None,
                 topology: Optional[LinkTopology] = None,
                 trace=None):
        assert len(specs) == len(engines)
        self.scheduler = scheduler or PerLLMScheduler(len(specs))
        super().__init__(self.scheduler, trace=trace)
        self.metrics = MetricsRegistry()
        if trace is not None \
                and getattr(self.scheduler, "bandit", None) is not None:
            # the bandit stamps ARM rows into the same recorder
            self.scheduler.bandit.trace = trace
        self.specs = list(specs)
        self.engines = list(engines)
        self.bandwidth = bandwidth or BandwidthModel()
        # the fleet's network: named links + per-server paths (defaults to
        # the degenerate one-private-link-per-server legacy model); link
        # occupancy is advanced by each dispatched request and shared
        # across steps (the fleet's links are stateful), `uplink_free_at`
        # mirrors each server's path for observers
        self.init_link_state(topology
                             or LinkTopology.degenerate(self.specs,
                                                        self.bandwidth))
        assert self.topology.n_servers == len(self.specs)
        # `slot` survives only as the bandwidth model's sampling cadence;
        # execution itself is event-driven
        self.slot = slot
        # per-slot factor cache: the factor the policy observed in a view
        # is the factor dispatch realizes (a fluctuating model's RNG
        # advances per draw, so repeated draws would diverge)
        self._factor_cache = (-1, {n: 1.0 for n in self.topology.links})
        self.uplink_free_at = [0.0] * len(specs)
        # per-engine logical clocks: each engine ticks at its own analytic
        # decode-step cadence, driven by InferStart events
        self.engine_clock = [0.0] * len(specs)
        # server-level DVFS state: the tier each host currently runs at.
        # A Decision's `alloc.freq_tier` retunes the target host at
        # dispatch; ticks then cost decode_step_time(tier) — scheduler-
        # chosen tiers mapped onto real decode-step pacing.
        self.engine_tier = [s.nominal_tier for s in self.specs]
        self._tick_scheduled = [False] * len(specs)
        # completion cursor per engine: eng.completed is append-only, so
        # each tick only inspects the new tail
        self._completed_seen = [0] * len(specs)
        self._idle_tick = min(s.decode_step_time() for s in self.specs)
        self._sid = itertools.count()
        self._by_sid: Dict[int, ServedRequest] = {}
        self._pending: List[ServedRequest] = []
        # routed but held back by Decision.defer_until (deferred batching):
        # the runtime — not the policy — applies the deferral
        self._deferred: List[ServedRequest] = []
        self.active: Dict[int, ServedRequest] = {}
        self.completed: List[ServedRequest] = []
        self.rejected: List[ServedRequest] = []
        self.n_preempted = 0
        self.n_kv_migrations = 0
        self.kv_migrated_bytes = 0.0

    # ------------------------------------------------------------------
    def submit(self, prompt: List[int], max_new_tokens: int = 16,
               deadline: float = 4.0,
               payload_bytes: float = 1e6) -> ServedRequest:
        svc = ServiceRequest(
            sid=next(self._sid), arrival=self.clock,
            prompt_tokens=len(prompt), output_tokens=max_new_tokens,
            deadline=deadline, payload_bytes=payload_bytes)
        svc.class_id = classify(svc)
        sr = ServedRequest(service=svc, submitted_clock=self.clock)
        sr._prompt = list(prompt)
        self._by_sid[svc.sid] = sr
        self._pending.append(sr)
        self.loop.push(Arrival(self.clock, requests=(svc,)))
        return sr

    # ------------------------------------------------------------------
    # Runtime contract: fresh views from real fleet state
    # ------------------------------------------------------------------
    def _link_factors(self, t: float) -> Dict[str, float]:
        k = int(t / self.slot)
        if self._factor_cache[0] != k:
            self._factor_cache = (k, self.topology.factors(k))
        return self._factor_cache[1]

    def _bw_factor(self, t: float, j: int) -> float:
        return self.topology.server_factor(
            j, self.specs[j].bandwidth, self._link_factors(t),
            self.link_scale)

    def on_bandwidth_change(self, ev: BandwidthChange) -> None:
        self.apply_bandwidth_scales(ev)

    def build_view(self, t: float) -> ClusterView:
        """Snapshot real fleet state: live link residuals, the topology's
        current per-link factor, and batch-lane occupancy from each active
        request's actual remaining decode tokens (queued and in-transit
        requests stack on as nominal bookings). Engine-resident requests
        are exposed as `running` tasks so preemption-capable policies can
        name a `preempt_victim`."""
        factors = self._link_factors(t)
        lane_free = []
        running: List[List[RunningTask]] = []
        by_engine_req = {id(sr.engine_req): sr for sr in self.active.values()
                         if sr.engine_req is not None}
        for j, eng in enumerate(self.engines):
            spec = self.specs[j]
            tier = self.engine_tier[j]
            step_t = spec.decode_step_time(tier=tier)
            base = max(self.engine_clock[j], t)
            lanes = [t] * spec.max_concurrency
            tasks: List[RunningTask] = []
            for slot in eng.active_slots:
                r = eng.slot_req[slot]
                remaining = max(r.max_new_tokens - len(r.generated), 0)
                li = int(np.argmin(lanes))
                lanes[li] = base + remaining * step_t
                sr = by_engine_req.get(id(r))
                if sr is not None:
                    svc = sr.service
                    tasks.append(RunningTask(
                        sid=svc.sid, server=j, class_id=svc.class_id,
                        deadline_at=svc.arrival + svc.deadline,
                        begin=sr.admit_clock if sr.admit_clock >= 0 else t,
                        finish_est=lanes[li], tier=tier))
            for r in eng.queue:
                li = int(np.argmin(lanes))
                lanes[li] = max(lanes[li], base) + spec.service_time(
                    len(r.prompt), r.max_new_tokens, tier=tier)
            for sr in self.active.values():
                if sr.server == j and sr.engine_req is None:
                    li = int(np.argmin(lanes))
                    lanes[li] = max(lanes[li], sr.dispatch_clock) \
                        + spec.service_time(len(sr._prompt),
                                            sr.service.output_tokens,
                                            tier=tier)
            lane_free.append(lanes)
            running.append(tasks)
        topo = self.topology
        tier_kwargs = {}
        if any(s.n_tiers > 1 for s in self.specs):
            # per-server tier state: the committed lane-seconds above,
            # attributed to each host's current DVFS tier
            tier_load = [[0.0] * s.n_tiers for s in self.specs]
            for j, lanes in enumerate(lane_free):
                tier_load[j][self.engine_tier[j]] = \
                    sum(max(lf - t, 0.0) for lf in lanes)
            tier_kwargs = dict(tier_load=tier_load)
        kv_kwargs = {}
        if any(eng.paged for eng in self.engines):
            # paged engines expose their allocator's live free count; a
            # dense engine's 0-total entry marks KV as unmodeled there
            kv_kwargs = dict(
                kv_free_blocks=[eng.kv.free_blocks if eng.paged else 0
                                for eng in self.engines],
                kv_total_blocks=[eng.kv.n_blocks if eng.paged else 0
                                 for eng in self.engines])
        return ClusterView(
            t=t, specs=self.specs,
            bw_factor=[self._bw_factor(t, j)
                       for j in range(len(self.specs))],
            uplink_free_at=[topo.path_free_at(j, self.link_free)
                            for j in range(len(self.specs))],
            lane_free=lane_free,
            running=running,
            **tier_kwargs,
            **kv_kwargs,
            **self.link_view_kwargs(t, factors))

    def _view(self) -> ClusterView:
        """Deprecated alias: the view at the current clock."""
        return self.build_view(self.clock)

    def slot_index(self, t: float) -> int:
        return int(t / self.slot)

    # ------------------------------------------------------------------
    # Event handlers: route -> transmit -> engine ticks -> finish
    # ------------------------------------------------------------------
    def place(self, t: float, svc: ServiceRequest,
              decision: Decision) -> None:
        sr = self._by_sid[svc.sid]
        sr.server = decision.server
        sr.decision = decision
        self._pending.remove(sr)
        if self.trace is not None and (svc.preemptions
                                       or not decision.admit):
            # markers only for the non-implicit placements (requeues and
            # sheds) — mirrors the sim cores' _trace_decision semantics
            alloc = decision.alloc
            tier = alloc.freq_tier if alloc is not None else 0
            self.trace.append_rows((
                (KIND_ARRIVAL, svc.sid, t, t, -1, svc.class_id, 0, 0.0,
                 svc.preemptions, -1),
                (KIND_DECISION, svc.sid, t, t, decision.server,
                 svc.class_id, tier, 0.0, decision.admit, -1),
            ))
        super().place(t, svc, decision)

    def defer(self, t: float, when: float, svc: ServiceRequest,
              decision: Decision) -> None:
        self._deferred.append(self._by_sid[svc.sid])
        super().defer(t, when, svc, decision)

    def dispatch(self, t: float, svc: ServiceRequest,
                 decision: Decision) -> None:
        """Start the uplink transfer; the engine takes over at TxDone.
        The transfer serializes on every link of the server's path (a
        sub-unit `alloc.bw_share` stretches it by 1/share), and the
        Decision's DVFS tier retunes the target host's decode pacing."""
        sr = self._by_sid[svc.sid]
        if sr in self._deferred:
            self._deferred.remove(sr)
        j = decision.server
        spec = self.specs[j]
        alloc = decision.alloc
        tier = alloc.freq_tier if alloc.freq_tier >= 0 else spec.nominal_tier
        self.engine_tier[j] = tier
        self.engines[j].set_freq_scale(spec.tier_freq(tier))
        path = self.topology.paths[j]
        tx_start = max(t, self.topology.path_free_at(j, self.link_free))
        tx_dur = spec.tx_time(svc.payload_bytes,
                              self._bw_factor(t, j) * alloc.bw_share)
        for name in path:
            self.link_free[name] = tx_start + tx_dur
        self.uplink_free_at[j] = tx_start + tx_dur
        ready = tx_start + tx_dur
        sr.tx_dur = tx_dur
        sr.tx_time = ready - svc.arrival
        sr.dispatch_clock = ready
        self.active[svc.sid] = sr
        self.loop.push(TxDone(ready, request=svc, decision=decision))

    def on_reject(self, ev: Reject) -> None:
        """Admission control shed the submission: emit the rejected
        Outcome (SLO-violation cost, zero fleet energy) and retire it."""
        svc = ev.request
        sr = self._by_sid.pop(svc.sid)
        # a runtime-forced shed (e.g. pool-oversized at TxDone) may arrive
        # after dispatch already put the request in `active`
        self.active.pop(svc.sid, None)
        if sr.evicted is not None:
            # a previously evicted request shed on requeue: its preserved
            # pages would otherwise leak on the old engine
            old_j, old_req = sr.evicted
            sr.evicted = None
            svc.kv_server, svc.kv_blocks = -1, 0
            self.engines[old_j].release(old_req)
        sr.server = -1
        sr.decision = ev.decision
        if self.trace is not None:
            self.trace.append(
                KIND_REJECT, svc.sid, ev.time, ev.time,
                ev.decision.server if ev.decision is not None else -1,
                svc.class_id)
        self.policy.feedback(svc, rejected_outcome(svc, ev.decision,
                                                   ev.time))
        self.rejected.append(sr)

    def on_preempt(self, ev: Preempt) -> None:
        """Evict the victim from its engine and requeue its remaining
        decode tokens as a fresh Arrival.

        On a paged engine `ServingEngine.evict` snapshots the victim's KV
        into its pages; the evicted engine Request is kept on the
        `ServedRequest` so that, if the requeue routes back to the same
        server, `on_tx_done` resubmits it and decode resumes with zero
        re-prefill. `ev.drop_kv` (or rerouting elsewhere) releases the
        pages instead. Dense engines keep the legacy semantics: the KV
        dies with the slot and prefill is redone wherever the victim
        lands."""
        sr = self.active.get(ev.victim)
        if sr is None or sr.engine_req is None:
            return            # finished, rejected, or still in transit
        eng = self.engines[sr.server]
        r = sr.engine_req
        evicted_from_slot = r.slot >= 0
        if evicted_from_slot:
            # drop_kv skips the snapshot scatter — the pages are being
            # freed for memory, not preserved for a resume
            eng.evict(r.slot, keep_kv=not ev.drop_kv)
            remaining = max(r.max_new_tokens - len(r.generated), 1)
        elif r in eng.queue:
            eng.queue.remove(r)
            if eng.paged:
                eng.release(r)   # queued: pages (if allocated) go back
            # a queued victim may itself be a resubmitted continuation
            # with tokens already generated — only the remainder requeues
            remaining = max(r.max_new_tokens - len(r.generated), 1)
        else:
            return            # completing this very tick — too late
        svc = sr.service
        if eng.paged and evicted_from_slot and not ev.drop_kv:
            sr.evicted = (sr.server, r)
            svc.kv_server = sr.server
            svc.kv_blocks = len(r.pages.blocks)
        svc.output_tokens = remaining
        svc.preemptions += 1
        if self.trace is not None:
            # span covers the in-batch window burned so far (a point at
            # ev.time if the victim never reached a lane); value = tokens
            # left to requeue
            t0 = sr.admit_clock if sr.admit_clock >= 0 else ev.time
            self.trace.append(KIND_PREEMPT, svc.sid, t0, ev.time,
                              sr.server, svc.class_id,
                              self.engine_tier[sr.server], 0.0,
                              float(remaining))
        sr.engine_req = None
        sr.server = -1
        sr.decision = None
        sr.dispatch_clock = -1.0
        sr.admit_clock = -1.0
        del self.active[svc.sid]
        self._pending.append(sr)
        self.n_preempted += 1
        self.loop.push(Arrival(ev.time, requests=(svc,)))

    def _resolve_eviction(self, sr: ServedRequest, j: int):
        """Decide what a rerouted, previously evicted request keeps: its
        engine Request (same paged server — resume in place) or nothing
        (different server — release the stranded pages there)."""
        if sr.evicted is None:
            return None
        old_j, old_req = sr.evicted
        sr.evicted = None
        sr.service.kv_server = -1
        sr.service.kv_blocks = 0
        if old_j == j and self.engines[j].paged and old_req.kv is not None:
            return old_req
        self.engines[old_j].release(old_req)
        return None

    def _kv_compatible(self, src: int, dst: int) -> bool:
        """Can pages move between these engines byte-for-byte? Same model
        config and page geometry on two paged engines."""
        a, b = self.engines[src], self.engines[dst]
        return (a.paged and b.paged and a.cfg == b.cfg
                and a.kv.block_tokens == b.kv.block_tokens
                and a.max_seq == b.max_seq)

    def _start_migration(self, sr: ServedRequest, j: int,
                         t: float) -> bool:
        """Begin shipping `sr`'s preserved pages from their home engine to
        server `j`, if the Decision asked for it and the move is possible
        (compatible engines, destination pool has room). The transfer
        occupies the union of both servers' link paths at the bottleneck
        bandwidth — exactly the simulator's charging rule — and the engine
        handoff resumes at `KvMigrate`. False = fall through to the normal
        release-and-re-prefill path."""
        if sr.evicted is None or sr.decision is None \
                or not sr.decision.migrate_kv:
            return False
        old_j, old_req = sr.evicted
        if old_j == j or not self._kv_compatible(old_j, j):
            return False
        dst = self.engines[j]
        n_blocks = len(old_req.pages.blocks)
        if dst.kv.free_blocks < n_blocks:
            return False
        n_bytes = n_blocks * self.engines[old_j].kv.block_tokens \
            * float(self.engines[old_j].cfg.kv_bytes_per_token())
        path = self.topology.migration_path(old_j, j)
        bw = self.topology.migration_bandwidth(
            old_j, j, self._link_factors(t), self.link_scale)
        if not path or bw <= 0.0 or n_bytes <= 0.0:
            return False
        start = max(t, max(self.link_free[name] for name in path))
        end = start + n_bytes * 8.0 / bw
        for name in path:
            self.link_free[name] = end
        self.n_kv_migrations += 1
        self.kv_migrated_bytes += n_bytes
        if self.trace is not None:
            self.trace.append(KIND_MIGRATE, sr.service.sid, t, end, j,
                              sr.service.class_id, 0,
                              (end - t) * self.specs[old_j].tx_power,
                              n_bytes, self.trace.intern(f"{old_j}->{j}"))
        self.loop.push(KvMigrate(end, request=sr.service,
                                 decision=sr.decision,
                                 context=(old_j, j, old_req)))
        return True

    def on_kv_migrate(self, ev: KvMigrate) -> None:
        """Migrated pages landed on the destination engine: export them
        from the source pool, adopt them into the destination's, and
        resubmit the continuation there — decode resumes with zero
        re-prefill. If the destination pool filled while the pages were
        in flight, fall back to a fresh submit (full re-prefill)."""
        svc = ev.request
        old_j, j, old_req = ev.context
        src, dst = self.engines[old_j], self.engines[j]
        sr = self.active.get(svc.sid)
        if sr is None:
            src.release(old_req)     # retired while the pages were in flight
            return
        pages = src.kv.export(old_req.pages)
        table = dst.kv.import_pages(pages, len(old_req.pages.blocks))
        sr.evicted = None
        svc.kv_server, svc.kv_blocks = -1, 0
        if table is None:
            src.release(old_req)
            sr.engine_req = dst.submit(
                sr._prompt, max_new_tokens=svc.output_tokens)
        else:
            new_req = Request(rid=next(dst._rid),
                              prompt=list(old_req.prompt),
                              max_new_tokens=old_req.max_new_tokens,
                              eos_id=old_req.eos_id,
                              generated=list(old_req.generated),
                              pages=table, kv=old_req.kv)
            old_req.kv = None        # the snapshot moved with the pages
            src.release(old_req)
            sr.engine_req = dst.resubmit(new_req)
            svc.kv_server, svc.kv_blocks = j, len(table.blocks)
            if self.trace is not None:
                self.trace.append(KIND_RESUME, svc.sid, ev.time, ev.time,
                                  j, svc.class_id)
        self._ensure_tick(j, ev.time)

    def on_tx_done(self, ev: TxDone) -> None:
        sr = self.active[ev.request.sid]
        j = sr.server
        eng = self.engines[j]
        if self._start_migration(sr, j, ev.time):
            return    # pages in flight: KvMigrate finishes the handoff
        resumable = self._resolve_eviction(sr, j)
        if resumable is not None:
            # KV-preserving requeue: reattach the evicted Request — its
            # page table and snapshot skip the prefill entirely
            sr.engine_req = eng.resubmit(resumable)
            if self.trace is not None:
                self.trace.append(KIND_RESUME, sr.service.sid, ev.time,
                                  ev.time, j, sr.service.class_id)
        elif eng.paged and eng.kv.blocks_for(
                len(sr._prompt) + sr.service.output_tokens) \
                > eng.kv.n_blocks:
            # the engine's whole pool can't hold this request — a KV-blind
            # policy routed it; shed it instead of crashing the loop
            self.handle(Reject(ev.time, request=ev.request,
                               decision=sr.decision))
            return
        else:
            sr.engine_req = eng.submit(
                sr._prompt, max_new_tokens=sr.service.output_tokens)
        self._ensure_tick(j, ev.time)

    def _ensure_tick(self, j: int, t: float) -> None:
        if not self._tick_scheduled[j]:
            self._tick_scheduled[j] = True
            self.loop.push(InferStart(max(t, self.engine_clock[j]),
                                      server=j))

    def on_infer_start(self, ev: InferStart) -> None:
        """One engine tick: admit + one real decode step on engine j,
        costing that server's analytic per-step latency at the host's
        current DVFS tier (a slow tier stretches each tick by 1/f)."""
        j = ev.server
        eng = self.engines[j]
        self._tick_scheduled[j] = False
        eng.step()
        t_end = ev.time + self.specs[j].decode_step_time(
            tier=self.engine_tier[j])
        self.engine_clock[j] = t_end
        self.clock = max(self.clock, t_end)
        for sr in self.active.values():
            if (sr.server == j and sr.engine_req is not None
                    and sr.admit_clock < 0 and sr.engine_req.slot >= 0):
                sr.admit_clock = ev.time
        new_done = eng.completed[self._completed_seen[j]:]
        self._completed_seen[j] = len(eng.completed)
        for r in new_done:
            for sr in list(self.active.values()):
                if sr.engine_req is r:
                    self._finish(sr, t_end)
        if eng.queue or eng.active_slots:
            self._ensure_tick(j, t_end)

    def _finish(self, sr: ServedRequest, t: float) -> None:
        sr.done_clock = t
        spec = self.specs[sr.server]
        # realized split: transmission (uplink wait + transfer), lane wait
        # (engine queue until prefill admission), inference window.
        # DVFS is host-level (last dispatch retunes the host), so the
        # inference energy is billed at the tier the host is actually
        # running — the frequency that paced the realized window — not at
        # the request's own decision tier, which a later dispatch may have
        # overridden mid-flight; shares stay per-request.
        alloc = sr.decision.alloc if sr.decision is not None else NOMINAL
        admit = sr.admit_clock if sr.admit_clock >= 0 else sr.dispatch_clock
        queue_time = max(admit - sr.dispatch_clock, 0.0)
        infer_time = max(sr.done_clock - admit, 0.0)
        tier = self.engine_tier[sr.server]
        e_inf = spec.infer_energy(infer_time, tier=tier,
                                  lane_share=alloc.lane_share)
        e_tx = spec.tx_power * sr.tx_dur * alloc.bw_share
        out = Outcome(server=sr.server, tx_time=sr.tx_time,
                      queue_time=queue_time, infer_time=infer_time,
                      finish=sr.done_clock, processing_time=sr.latency,
                      success=sr.met_deadline, energy=e_inf + e_tx)
        if self.trace is not None:
            svc, trace = sr.service, self.trace
            trace.complete(svc.sid, svc.arrival, sr.dispatch_clock,
                           admit, sr.done_clock, sr.server,
                           svc.class_id, tier, -1, e_tx, e_inf,
                           svc.output_tokens, sr.met_deadline)
        self.policy.feedback(sr.service, out)
        self.completed.append(sr)
        del self.active[sr.service.sid]
        del self._by_sid[sr.service.sid]

    # ------------------------------------------------------------------
    def step(self) -> int:
        """Process the next event on the runtime loop (an arrival batch, a
        dispatch window, an uplink completion, or one engine's decode
        tick). With nothing scheduled the clock idles forward one minimal
        engine tick."""
        if not self.loop:
            self.clock += self._idle_tick
            return 0
        self.handle(self.loop.pop())
        return sum(len(e.active_slots) for e in self.engines)

    def run_until_idle(self,
                       max_steps: int = 1_000_000) -> List[ServedRequest]:
        """Drain the service. `max_steps` counts *events* (finer-grained
        than the old fleet-wide steps: each engine tick, transfer
        completion and routing is one step), so the default budget is a
        runaway backstop, not a workload bound."""
        for _ in range(max_steps):
            if not self._pending and not self._deferred and not self.active:
                break
            self.step()
        return self.completed

    # ------------------------------------------------------------------
    @property
    def stats(self) -> dict:
        """Canonical fleet stats (one key namespace with
        ``SimResult.stats()``), plus the deprecated pre-unification
        spellings via :func:`repro_torch.obs.metrics.with_aliases` — old
        readers of e.g. ``served`` / ``deadline_met`` keep working for
        one release. The same values land in ``self.metrics``."""
        done = self.completed
        m = self.metrics
        m.put_scalar("n_served", len(done))
        m.put_scalar("n_rejected", len(self.rejected))
        if not done:
            return with_aliases({"n_served": 0,
                                 "n_rejected": len(self.rejected),
                                 "n_preempted": self.n_preempted})
        lat = np.array([sr.latency for sr in done])
        per_server = np.bincount([sr.server for sr in done],
                                 minlength=len(self.specs)).tolist()
        stats = {
            "n_served": len(done),
            "n_rejected": len(self.rejected),
            "n_preempted": self.n_preempted,
            "n_kv_migrations": self.n_kv_migrations,
            "kv_migrated_bytes": self.kv_migrated_bytes,
            "n_prefills": sum(e.n_prefills for e in self.engines),
            "n_prefix_hits": sum(e.n_prefix_hits for e in self.engines),
            "kv_prefill_tokens_saved": sum(e.prefix_tokens_reused
                                           for e in self.engines),
            "admitted_success_rate": float(np.mean([sr.met_deadline
                                                    for sr in done])),
            "avg_processing_time": float(lat.mean()),
            "per_server_served": per_server,
        }
        for key in ("n_prefills", "n_prefix_hits",
                    "kv_prefill_tokens_saved"):
            m.put_scalar(key, stats[key])
        for j, n in enumerate(per_server):
            m.put("per_server_served", n, server=j)
        m.set_gauge("admitted_success_rate",
                    stats["admitted_success_rate"])
        m.set_gauge("avg_processing_time", stats["avg_processing_time"])
        return with_aliases(stats)
