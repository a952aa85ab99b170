"""Reference event-driven runtime — the retained slow path.

This is the pre-vectorization `_EventSimRuntime`, kept verbatim as the
semantic oracle for the array-backed fast core in
`repro_torch.cluster.simulator`. `Simulator(core="reference")` runs it; the
property tests in `tests/test_scale_equivalence.py` pin the fast core
result-identical (SimResult counters and per-outcome times) to this
implementation on randomized workloads.

Nothing here is optimized on purpose: every view is materialized eagerly
from scratch and every event is a dataclass through the generic
`Runtime.handle` path, which is exactly what makes it a trustworthy
reference.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from repro_torch.cluster.simulator import (
    Outcome, _Booking, _PrefixEntry, _SimRuntimeBase,
)
from repro_torch.cluster.workload import ServiceRequest
from repro_torch.core.api import ClusterView, Decision, RunningTask
from repro_torch.obs.trace import KIND_MIGRATE, KIND_PREEMPT
from repro_torch.core.runtime import (
    Arrival, BandwidthChange, InferDone, KvMigrate, Preempt, Reject, TxDone,
)


class _ReferenceEventRuntime(_SimRuntimeBase):
    """Pure event-driven semantics.

    Every arrival observes a fresh view of the cluster at its actual
    timestamp; physics are resolved at dispatch (links and lane booked
    immediately, so later arrivals see the consumed capacity) while the
    timeline unfolds as TxDone → InferStart → InferDone events, with energy
    accounting and policy feedback at the times things actually happen.
    Bookings stay in `_inflight` until completion, which is what gives
    views their `running` tasks and `Preempt` a victim ledger to roll back.
    """

    def __init__(self, sim: "Simulator", policy, trace=None) -> None:
        super().__init__(sim, policy, trace=trace)
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
        if any(link.fluctuating for link in self.topo.links.values()):
            self._resample_factors(0.0)

    # ---------------- bandwidth as an event stream -----------------------
    def _resample_factors(self, t: float) -> None:
        k = int(round(t / self.sim.bw_interval))
        self._link_factors = self.topo.factors(k)
        self.loop.push(BandwidthChange(t + self.sim.bw_interval,
                                       resample=True))

    def on_bandwidth_change(self, ev: BandwidthChange) -> None:
        super().on_bandwidth_change(ev)
        if ev.resample:
            self._resample_factors(ev.time)

    def _factor(self, j: int) -> float:
        return self.server_factor(j, self._link_factors)

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

    # ---------------- the Runtime contract -------------------------------
    def slot_index(self, t: float) -> int:
        return int(t / self.sim.bw_interval)

    def build_view(self, t: float) -> ClusterView:
        n = len(self.specs)
        running: List[List[RunningTask]] = [[] for _ in range(n)]
        for sid, b in self._inflight.items():
            running[b.j].append(RunningTask(
                sid=sid, server=b.j, class_id=b.request.class_id,
                deadline_at=b.request.arrival + b.request.deadline,
                begin=b.begin, finish_est=b.finish,
                tier=b.alloc.freq_tier))
        tier_kwargs = {}
        if any(s.n_tiers > 1 for s in self.specs):
            # per-server tier state: committed in-flight lane-seconds per
            # DVFS tier (the within-batch commits stack on via the view's
            # own `commit`)
            tier_load = [[0.0] * s.n_tiers for s in self.specs]
            for b in self._inflight.values():
                k = b.alloc.freq_tier
                if k < 0:
                    k = self.specs[b.j].nominal_tier
                tier_load[b.j][k] += max(b.finish - max(b.begin, t), 0.0)
            tier_kwargs = dict(tier_load=tier_load)
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
        return ClusterView(
            t=t, specs=self.specs,
            bw_factor=[self._factor(j) for j in range(n)],
            uplink_free_at=[self.topo.path_free_at(j, self.link_free)
                            for j in range(n)],
            lane_free=[list(lf) for lf in self.lane_free],
            running=running,
            **tier_kwargs,
            **kv_kwargs,
            **self.link_view_kwargs(t, self._link_factors),
        )

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
        tx_start = max(t, self.topo.path_free_at(j, self.link_free))
        # a sub-unit bandwidth share stretches the transfer by 1/share and
        # occupies the path for the whole stretched window (exclusive-
        # window semantics: shares can never oversubscribe a link)
        tx_dur = spec.tx_time(req.payload_bytes,
                              self._factor(j) * alloc.bw_share)
        end = tx_start + tx_dur
        # a transfer occupies its whole path
        for name in self.topo.paths[j]:
            self.link_free[name] = end
        st.uplink_free_at = end
        ready = end
        # the lane is booked at dispatch — the routed request is committed
        # capacity, visible to every later arrival's fresh view — while the
        # events below mark when its phases actually happen
        lanes = self.lane_free[j]
        li = int(np.argmin(lanes))
        lane_prev = lanes[li]
        begin = max(ready, lane_prev)
        t_inf = self.sim._draw_infer(req, j, resume=kv_resumed, alloc=alloc,
                                     prefix_tokens=prefix_saved)
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
        self.loop.push(TxDone(ready, request=req, decision=decision,
                              context=ctx))
        self.loop.push(InferDone(finish, request=req, context=ctx))

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
        for name in path:
            self.link_free[name] = end
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

    def on_tx_done(self, ev: TxDone) -> None:
        b: _Booking = ev.context
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

    def on_infer_done(self, ev: InferDone) -> None:
        b: _Booking = ev.context
        if b.cancelled:
            return                       # preempted: the requeue completes
        req = ev.request
        self._inflight.pop(req.sid, None)
        spec = self.specs[b.j]
        st = self.states[b.j]
        finish = ev.time
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
