"""PerLLM scheduler: CS-UCB service scheduling + resource allocation.

Implements paper Algorithm 1 as a `SchedulingPolicy`. Per slot, arrivals
are assigned sequentially (building the super arm): for each service the
constraint-satisfaction mechanism filters the feasible (server, DVFS tier)
pairs using *learned* processing-time estimates, and CS-UCB picks the
feasible arm with the best UCB score — placement and compute allocation
are one joint decision (paper Eq. 1). The runtime commits each `Decision`'s
residuals before asking for the next one, so later services in the same
slot see the reduced capacity (C2/C3 accounting).

Tier selection is where the energy story lives: a slower tier stretches
inference (time ∝ 1/f) but cuts dynamic power cubically, so energy per
token falls as f² — the bandit's reward (−energy + λ·f(y)⁻) converges to
the *cheapest* feasible allocation per (class, server), not the fastest.
On a single-tier testbed the arm space degenerates to (class, server) and
the trajectory is bit-exact with the placement-only scheduler.

Observed outcomes arrive via `feedback`: reward = −energy_norm + λ·f(y)
(Eq. 4, f(y) clipped into [−1, 0] — see `repro_torch.core.bandit`), plus a
violation-severity update that drives the penalty term P(t).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np

from repro_torch.cluster.workload import N_CLASSES
from repro_torch.core.api import Allocation, ClusterView, Decision, \
    SchedulingPolicy, register_policy
from repro_torch.core.bandit import CSUCB, CSUCBParams
from repro_torch.core.constraints import ConstraintSlacks, evaluate_constraints

# Energy normalization scale (J) — a typical per-service energy magnitude;
# keeps the two reward terms in Eq. 4 comparable. Calibrated so the
# energy differences between DVFS tiers of one server are visible above
# the UCB exploration term (with f(y) clipped into [−1, 0] the energy
# term is what ranks feasible arms).
E_SCALE = 60.0


@register_policy("perllm")
class PerLLMScheduler(SchedulingPolicy):
    """`admission=True` turns the C1 failover into admission control: when
    no server can satisfy the constraints, the request is shed
    (`Decision.admit=False`) instead of being dumped on the least-bad
    server — under sustained overload this is what keeps *admitted*
    requests inside their SLOs. `preempt=True` additionally lets an
    otherwise-infeasible request reclaim a lane from a running task that
    is already doomed to miss its own deadline (`Decision.preempt_victim`,
    event-driven runtimes only). `tiers=False` pins every decision to the
    nominal DVFS tier — the fixed-frequency comparator the energy
    benchmarks (and the nominal-tier golden test) run against."""

    name = "PerLLM"

    def __init__(self, n_servers: int, params: Optional[CSUCBParams] = None,
                 seed: int = 0, admission: bool = False,
                 preempt: bool = False, tiers: bool = True):
        self.n_servers = n_servers
        self.admission = admission
        self.preempt = preempt
        self.tiers = tiers
        self._seed = seed
        self._params = params
        self.bandit = CSUCB(N_CLASSES, n_servers, params, seed=seed)
        # learned per-(class, server) processing-time ratio vs the nominal
        # analytic estimate (captures hidden efficiency + congestion)
        self.time_ratio = np.ones((N_CLASSES, n_servers), np.float64)
        self.ratio_count = np.zeros((N_CLASSES, n_servers), np.int64)
        # prediction-error second moment -> pessimistic C1 margin
        self.err_var = np.zeros((N_CLASSES, n_servers), np.float64)
        # per-(class, server) inference-time ratio (hidden efficiency)
        self.infer_ratio = np.ones((N_CLASSES, n_servers), np.float64)
        self._pending_slacks: Dict[int, ConstraintSlacks] = {}
        self._pending_tier: Dict[int, int] = {}
        self._nominal_pred: Dict[int, float] = {}
        self._last_nominal_infer: Dict[int, float] = {}
        # static per-(server, tier) arm table, built on first view contact
        self._arm_cache = None
        self._init_mirrors()

    # ------------------------------------------------------------------
    # C1 safety margin: guards against realization noise and within-slot
    # queue drift when checking the processing-time constraint.
    SAFETY = 1.05
    # Non-nominal DVFS tiers deliberately spend deadline slack for energy,
    # so they get a stricter bar than bare feasibility: the predicted time
    # must leave TIER_GUARD relative headroom, and the (class, server)
    # estimators must have seen a few calibration outcomes first (slowing
    # a server down before its hidden efficiency is known converts
    # prediction error straight into SLO misses).
    TIER_GUARD = 0.05
    TIER_WARMUP = 3
    # ... and the server must retain lane-capacity headroom (C2 slack):
    # downtiering occupies the lane longer, and on a loaded server that
    # stolen lane-time surfaces as queue drift for *later, nominal-tier*
    # requests — the misses show up far from the arm that caused them, so
    # the bandit's own penalty cannot learn them away.
    TIER_COMPUTE_GUARD = 0.25
    # Adaptive component: the time-headroom bar rises with the
    # (class, server)'s observed violation severity (the bandit's V̄,
    # congestion-coupled across tiers), so a host whose requests have been
    # missing deadlines stops being downtiered until it cools off.
    TIER_VIOL_GAIN = 2.0
    # Allocation-aware admission: with DVFS tiers in play, committed lane
    # windows are stretched and queue-drift error correspondingly larger,
    # so an admission-enabled tiered scheduler demands this much positive
    # C1 headroom on the arm it admits on — slack is spent on energy, not
    # on risky admits. Inactive without `admission` or on untiered specs.
    TIER_ADMIT_GUARD = 0.02

    def _tier_table(self, view: ClusterView) -> List[List[int]]:
        """Per-server candidate tier indices (just the nominal tier when
        tier selection is disabled), sizing the bandit's arm space on
        first contact with the cluster's specs."""
        if not self.tiers:
            return [[spec_nominal(view.specs[j])]
                    for j in range(self.n_servers)]
        table = [list(range(view.n_tiers(j)))
                 for j in range(self.n_servers)]
        width = max(len(t) for t in table)
        if width != self.bandit.n_tiers:
            # first view revealed the real tier count: rebuild the (so far
            # unpulled) bandit over the (class, server, tier) arm space,
            # carrying over any attached trace recorder
            trace = self.bandit.trace
            self.bandit = CSUCB(N_CLASSES, self.n_servers, self._params,
                                seed=self._seed, n_tiers=width)
            self.bandit.trace = trace
        return table

    def _arm_table(self, view: ClusterView):
        """Static arm geometry for a cluster: the tier table plus, per
        (server, slot), the reusable Allocation object, its time-stretch
        denominator freq·lane_share, and that denominator's reciprocal
        (the C1 margin stretch). Allocation objects and these floats are
        pure functions of the specs, so they are computed once per cluster
        instead of once per arrival — keyed on the identity of
        `view.specs`, which every view of one simulation shares."""
        cache = self._arm_cache
        if cache is not None and cache[0] is view.specs:
            return cache
        table = self._tier_table(view)   # may rebuild the bandit
        width = self.bandit.n_tiers
        nominals = [spec_nominal(view.specs[j])
                    for j in range(self.n_servers)]
        allocs, denoms, inv_stretch = [], [], []
        svc = []
        for j in range(self.n_servers):
            spec = view.specs[j]
            row_a: List[Allocation] = []
            row_d: List[float] = []
            row_i: List[float] = []
            for k in table[j]:
                a = Allocation(freq_tier=k)
                d = a.freq(spec) * a.lane_share
                row_a.append(a)
                row_d.append(d)
                row_i.append(1.0 / d)
            allocs.append(row_a)
            denoms.append(row_d)
            inv_stretch.append(row_i)
            # nominal service_time(p, o) unrolled to (2A·p)/flops + o·dst
            # — the same left-associated ops as prefill_time + decode_time
            # at tier −1 (whose ÷tier_freq is an exact ÷1.0), with the
            # request-independent factors hoisted
            svc.append((2.0 * spec._active_params, spec.flops,
                        spec.decode_step_time(1, -1)))
        self._init_mirrors()   # bandit may have been swapped above
        cache = (view.specs, table, width, nominals, allocs, denoms,
                 inv_stretch, svc)
        self._arm_cache = cache
        return cache

    # ------------------------------------------------------------------
    # Scalar read-mirrors of the learned numpy state. The numpy arrays
    # stay the single source of truth (every update in `feedback` touches
    # them exactly as before); the mirrors are plain-python copies
    # refreshed per feedback so the per-arrival hot loop in `assign` reads
    # floats instead of paying numpy scalar-indexing overhead ~100× per
    # arrival. Values are bit-identical by construction.
    def _init_mirrors(self) -> None:
        b = self.bandit
        self._b_mean = b.mean.tolist()
        self._b_count = b.count.tolist()
        self._b_viol = b.violation.tolist()
        self._viol_mean = [[float(np.mean(b.violation[c, j]))
                           for j in range(self.n_servers)]
                          for c in range(N_CLASSES)]
        self._warm = [[bool(self.ratio_count[c, j] >= self.TIER_WARMUP)
                       for j in range(self.n_servers)]
                      for c in range(N_CLASSES)]
        self._time_ratio_f = self.time_ratio.tolist()
        self._err_sqrt = np.sqrt(self.err_var).tolist()
        self._infer_ratio_f = self.infer_ratio.tolist()

    def _refresh_mirrors(self, cls: int, j: int) -> None:
        b = self.bandit
        self._b_mean[cls][j] = b.mean[cls, j].tolist()
        self._b_count[cls][j] = b.count[cls, j].tolist()
        self._b_viol[cls][j] = vrow = b.violation[cls, j].tolist()
        # == float(np.mean(...)): sequential left sum for < 8 elements
        self._viol_mean[cls][j] = sum(vrow) / len(vrow)
        self._warm[cls][j] = bool(self.ratio_count[cls, j]
                                  >= self.TIER_WARMUP)
        self._time_ratio_f[cls][j] = float(self.time_ratio[cls, j])
        self._err_sqrt[cls][j] = math.sqrt(float(self.err_var[cls, j]))
        self._infer_ratio_f[cls][j] = float(self.infer_ratio[cls, j])

    def predicted_time(self, req, j: int, view: ClusterView,
                       alloc: Optional[Allocation] = None) -> float:
        cls = req.class_id
        d_hat = (view.predict_tx(req, j, alloc)
                 + view.predict_queue(req, j, alloc)
                 + view.predict_infer(req, j, alloc)
                 * self.infer_ratio[cls, j])
        # the pessimistic margin grows with the allocation's stretch:
        # realization error is proportional to how long the work runs, so
        # a half-frequency tier doubles the guard band (exact at nominal)
        stretch = 1.0 if alloc is None \
            else 1.0 / (alloc.freq(view.specs[j]) * alloc.lane_share)
        margin = math.sqrt(self.err_var[cls, j]) * stretch
        return d_hat * self.time_ratio[cls, j] * self.SAFETY + margin

    def assign(self, req, view: ClusterView) -> Decision:
        """Hot path: one fused pass per (server, tier) arm — constraint
        filter, C1 prediction and the CS-UCB score are evaluated together
        and only the running best arm is tracked, so nothing is stored
        per arm. Decision branches that need the whole feasibility grid
        (KV-affinity resumes, prefix routing, allocation-aware admission)
        divert to `_assign_scan`, which keeps the array-building
        formulation. Both paths replicate the float operations of
        predicted_time + evaluate_constraints + CSUCB.select term for
        term, so trajectories are bit-identical to the reference
        formulation — pinned by the golden suites and
        tests/test_scale_equivalence.py."""
        kv_home = getattr(req, "kv_server", -1)
        n = self.n_servers
        if ((0 <= kv_home < n and getattr(req, "kv_blocks", 0) > 0)
                or (self.admission and self.bandit.n_tiers > 1)
                or (getattr(req, "prefix_id", -1) >= 0
                    and getattr(view, "prefix_hit_tokens", None)
                    is not None)):
            return self._assign_scan(req, view)
        specs_ref, tier_table, width, nominals, allocs, denoms, \
            inv_stretch, svc = self._arm_table(view)
        cls = req.class_id
        specs = view.specs
        t = view.t
        deadline = req.deadline
        need_bits = req.payload_bytes * 8.0
        p_tok = req.prompt_tokens
        o_tok = req.output_tokens
        lane_free = view.lane_free
        uplink = view.uplink_free_at
        bw_factor = view.bw_factor
        kv_totals = view.kv_total_blocks
        time_ratio = self._time_ratio_f[cls]
        err_sqrt = self._err_sqrt[cls]
        infer_r = self._infer_ratio_f[cls]
        viol_mean = self._viol_mean[cls]
        warm = self._warm[cls]
        SAFETY = self.SAFETY
        b_mean = self._b_mean[cls]
        b_count = self._b_count[cls]
        b_viol = self._b_viol[cls]
        p = self.bandit.p
        delta = p.delta
        neg_theta = -p.theta
        bt = self.bandit.t
        logt = math.log(bt if bt > 2 else 2)
        e0 = delta * math.sqrt(logt)   # == delta * sqrt(logt / max(0, 1))
        tg = self.TIER_GUARD
        tvg = self.TIER_VIOL_GAIN
        tcg = self.TIER_COMPUTE_GUARD
        txq = [0.0] * n
        infer0 = [0.0] * n
        ks_arr = [1.0] * n
        have = False
        best = 0.0
        j = 0
        slot = 0
        c_ts = c_cs = c_bs = c_pred = c_inf = 0.0
        c_ks = 1.0
        for jj in range(n):
            spec = specs[jj]
            lanes = lane_free[jj]
            u = uplink[jj]
            backlog = u - t if u > t else 0.0
            bwj = spec.bandwidth * bw_factor[jj]
            tx = backlog + need_bits / bwj
            ready = t + tx
            lane_min = min(lanes)
            q = lane_min - ready
            if q < 0.0:
                q = 0.0
            cap_bits = bwj * deadline
            used_bits = backlog * bwj
            twoa, flops, dst = svc[jj]
            nominal_inf = twoa * p_tok / flops + o_tok * dst
            txq[jj] = txq_j = tx + q
            infer0[jj] = nominal_inf
            ks = 1.0
            if kv_totals is not None and kv_totals[jj] > 0:
                # no resume case here: requests holding KV pages divert
                # to _assign_scan above
                kv_need = spec.kv_blocks_needed(p_tok, o_tok)
                hit_fn = getattr(view, "prefix_hit_tokens", None)
                if hit_fn is not None:
                    kv_need -= hit_fn(req, jj) \
                        // max(spec.kv_block_tokens, 1)
                ks = (view.kv_free_blocks[jj] - kv_need) / kv_totals[jj]
            ks_arr[jj] = ks
            bs = (cap_bits - used_bits - need_bits) / cap_bits
            if bs < 0.0 or ks < 0.0:
                # tier-independent C3/C5 violation: no tier of this
                # server can be feasible, and unchosen arms leave no
                # other trace on this path
                continue
            committed = 0.0
            for lf in lanes:
                d_ = lf - t
                if d_ > 0.0:
                    committed += d_
            capacity = spec.max_concurrency * deadline
            nominal_k = nominals[jj]
            guard = None
            w_j = warm[jj]
            tr = time_ratio[jj]
            es = err_sqrt[jj]
            ir = infer_r[jj]
            row_table = tier_table[jj]
            row_denom = denoms[jj]
            row_inv = inv_stretch[jj]
            mrow = b_mean[jj]
            crow = b_count[jj]
            vrow = b_viol[jj]
            for s_ in range(len(row_table)):
                inf_a = nominal_inf / row_denom[s_]
                d_hat = (txq_j + inf_a * ir) * tr * SAFETY \
                    + es * row_inv[s_]
                ts = (deadline - d_hat) / deadline
                cs = (capacity - committed - inf_a) / capacity
                ok = ts >= 0.0 and cs >= 0.0 and bs >= 0.0 and ks >= 0.0
                if ok and row_table[s_] != nominal_k:
                    if guard is None:
                        guard = tg + tvg * viol_mean[jj]
                    ok = w_j and ts >= guard and cs >= tcg
                if not ok:
                    continue
                cnt = crow[s_]
                if cnt == 0:
                    sc = mrow[s_] + e0 + 1e3 + neg_theta * vrow[s_]
                else:
                    sc = mrow[s_] + delta * math.sqrt(logt / cnt) \
                        + neg_theta * vrow[s_]
                if not have or sc > best:
                    best = sc
                    have = True
                    j = jj
                    slot = s_
                    c_ts, c_cs, c_bs, c_ks = ts, cs, bs, ks
                    c_pred, c_inf = d_hat, inf_a
        admit = True
        victim = None
        drop_kv = False
        if not have:
            # C1 failover (paper §3.1): predicted_time(alloc=None)
            # argmin, inlined from the per-server terms of the scan
            best_d = math.inf
            j = 0
            for jj in range(n):
                d0 = (txq[jj] + infer0[jj] * infer_r[jj]) \
                    * time_ratio[jj] * SAFETY + err_sqrt[jj]
                if d0 < best_d:
                    best_d, j = d0, jj
            slot = tier_table[j].index(nominals[j]) \
                if nominals[j] in tier_table[j] else 0
            if self.preempt:
                victim = self._find_victim(req, view)
            if victim is not None:
                j = victim.server
                slot = tier_table[j].index(nominals[j]) \
                    if nominals[j] in tier_table[j] else 0
                drop_kv = ks_arr[j] < 0.0
            elif self.admission:
                admit = False
            # slacks/prediction of the (infeasible) chosen arm, computed
            # exactly as the scan would have
            spec = specs[j]
            lanes = lane_free[j]
            committed = 0.0
            for lf in lanes:
                d_ = lf - t
                if d_ > 0.0:
                    committed += d_
            capacity = spec.max_concurrency * deadline
            u = uplink[j]
            backlog = u - t if u > t else 0.0
            bwj = spec.bandwidth * bw_factor[j]
            c_inf = infer0[j] / denoms[j][slot]
            c_pred = (txq[j] + c_inf * infer_r[j]) * time_ratio[j] \
                * SAFETY + err_sqrt[j] * inv_stretch[j][slot]
            c_ts = (deadline - c_pred) / deadline
            c_cs = (capacity - committed - c_inf) / capacity
            c_bs = (bwj * deadline - backlog * bwj - need_bits) \
                / (bwj * deadline)
            c_ks = ks_arr[j]
        alloc = allocs[j][slot]
        slacks = ConstraintSlacks(time=c_ts, compute=c_cs,
                                  bandwidth=c_bs, kv=c_ks)
        self._pending_slacks[req.sid] = slacks
        self._pending_tier[req.sid] = slot
        self._nominal_pred[req.sid] = c_pred / SAFETY
        self._last_nominal_infer[req.sid] = c_inf
        # migrate_kv needs a KV home, which diverts to _assign_scan
        return Decision(server=j, alloc=alloc,
                        infer_scale=infer_r[j],
                        slacks=slacks, admit=admit,
                        preempt_victim=None if victim is None
                        else victim.sid,
                        preempt_drop_kv=drop_kv,
                        migrate_kv=False)

    def _assign_scan(self, req, view: ClusterView) -> Decision:
        # Full-grid scan: builds the complete feasibility/slack arrays the
        # rare decision branches need (KV-affinity resume, prefix routing,
        # allocation-aware admission, preemption bookkeeping). Arithmetic
        # is the scalar unrolling of predicted_time + evaluate_constraints
        # replicated term for term (same association order, same max/min
        # semantics) so trajectories stay bit-identical to the vector
        # formulation — see the golden suites.
        specs_ref, tier_table, width, nominals, allocs, denoms, \
            inv_stretch, svc = self._arm_table(view)
        cls = req.class_id
        n = self.n_servers
        specs = view.specs
        t = view.t
        deadline = req.deadline
        need_bits = req.payload_bytes * 8.0
        p_tok = req.prompt_tokens
        o_tok = req.output_tokens
        lane_free = view.lane_free
        uplink = view.uplink_free_at
        bw_factor = view.bw_factor
        kv_totals = view.kv_total_blocks
        time_ratio = self._time_ratio_f[cls]
        err_sqrt = self._err_sqrt[cls]
        infer_r = self._infer_ratio_f[cls]
        viol_mean = self._viol_mean[cls]
        warm = self._warm[cls]
        SAFETY = self.SAFETY
        nw = n * width
        feas = [False] * nw
        s_time = [0.0] * nw
        s_comp = [0.0] * nw
        s_bw = [0.0] * nw
        s_kv = [1.0] * nw
        pred = [0.0] * nw
        infer_nom = [0.0] * nw
        txq = [0.0] * n
        infer0 = [0.0] * n
        feas_any = False
        for j in range(n):
            spec = specs[j]
            lanes = lane_free[j]
            u = uplink[j]
            backlog = u - t if u > t else 0.0
            bwj = spec.bandwidth * bw_factor[j]
            tx = backlog + need_bits / bwj
            ready = t + tx
            lane_min = min(lanes)
            q = lane_min - ready
            if q < 0.0:
                q = 0.0
            committed = 0.0
            for lf in lanes:
                d_ = lf - t
                if d_ > 0.0:
                    committed += d_
            capacity = spec.max_concurrency * deadline
            cap_bits = bwj * deadline
            used_bits = backlog * bwj
            twoa, flops, dst = svc[j]
            nominal_inf = twoa * p_tok / flops + o_tok * dst
            txq[j] = txq_j = tx + q
            infer0[j] = nominal_inf
            guard = self.TIER_GUARD + self.TIER_VIOL_GAIN * viol_mean[j]
            nominal_k = nominals[j]
            w_j = warm[j]
            tr = time_ratio[j]
            es = err_sqrt[j]
            ir = infer_r[j]
            base = j * width
            row_table = tier_table[j]
            row_denom = denoms[j]
            row_inv = inv_stretch[j]
            ks = 1.0
            if kv_totals is not None and kv_totals[j] > 0:
                # tier-invariant, so computed once per server
                if getattr(req, "kv_server", -1) == j \
                        and getattr(req, "kv_blocks", 0) > 0:
                    kv_need = 0
                else:
                    kv_need = spec.kv_blocks_needed(p_tok, o_tok)
                    hit_fn = getattr(view, "prefix_hit_tokens", None)
                    if hit_fn is not None:
                        kv_need -= hit_fn(req, j) \
                            // max(spec.kv_block_tokens, 1)
                ks = (view.kv_free_blocks[j] - kv_need) / kv_totals[j]
            for slot in range(len(row_table)):
                inf_a = nominal_inf / row_denom[slot]
                d_hat = (txq_j + inf_a * ir) * tr * SAFETY \
                    + es * row_inv[slot]
                ts = (deadline - d_hat) / deadline
                cs = (capacity - committed - inf_a) / capacity
                bs = (cap_bits - used_bits - need_bits) / cap_bits
                ok = ts >= 0.0 and cs >= 0.0 and bs >= 0.0 and ks >= 0.0
                if ok and row_table[slot] != nominal_k:
                    ok = w_j and ts >= guard \
                        and cs >= self.TIER_COMPUTE_GUARD
                idx = base + slot
                feas[idx] = ok
                s_time[idx] = ts
                s_comp[idx] = cs
                s_bw[idx] = bs
                s_kv[idx] = ks
                pred[idx] = d_hat
                infer_nom[idx] = inf_a
                if ok:
                    feas_any = True
        admit = True
        victim = None
        drop_kv = False
        kv_home = getattr(req, "kv_server", -1)
        if 0 <= kv_home < n and getattr(req, "kv_blocks", 0) > 0 \
                and any(feas[kv_home * width:
                             kv_home * width + len(tier_table[kv_home])]):
            # KV affinity: this request's pages survived a preemption on
            # kv_home — resuming there skips the whole re-prefill, which
            # no other feasible server can offer. Requeues are rare, so
            # bypassing the bandit here costs negligible exploration; take
            # the lowest-frequency (cheapest) feasible tier on the KV home
            # — by actual frequency, not table position (tables need not
            # be sorted).
            j = kv_home
            base = j * width
            row_table = tier_table[j]
            ft = specs[j].freq_tiers
            slot = -1
            best_f = 0.0
            for s_ in range(len(row_table)):
                if feas[base + s_]:
                    fv = ft[row_table[s_]]
                    if slot < 0 or fv < best_f:
                        slot, best_f = s_, fv
        elif feas_any:
            hit_fn = getattr(view, "prefix_hit_tokens", None)
            prefix_case = hit_fn is not None \
                and getattr(req, "prefix_id", -1) >= 0
            admit_case = self.admission and self.bandit.n_tiers > 1
            if prefix_case or admit_case:
                # rare branches keep the vectorized formulation verbatim
                feasible = np.array(
                    [[feas[jj * width + s_] for s_ in range(width)]
                     for jj in range(n)], bool)
                guarded = feasible
                if prefix_case:
                    # prefix-affinity routing: among feasible servers,
                    # prefer the ones already holding this request's
                    # shared system prompt — landing there skips that much
                    # prefill and pins only the unique suffix. Ties leave
                    # the bandit's arm space untouched.
                    hits = np.array([hit_fn(req, jj) for jj in range(n)])
                    if hits.max() > 0:
                        aff = guarded & (hits == hits.max())[:, None]
                        if aff.any():
                            guarded = aff
                if admit_case:
                    # allocation-aware admission: prefer arms that leave
                    # TIER_ADMIT_GUARD of C1 headroom; shed only when *no*
                    # feasible arm has it (a bare-feasible arm is never
                    # shed while a roomier alternative exists — rejected
                    # outcomes carry no bandit update, so shedding the
                    # deterministic first pick would starve a class
                    # forever)
                    roomy = np.array(
                        [[s_ < len(tier_table[jj])
                          and s_time[jj * width + s_]
                          >= self.TIER_ADMIT_GUARD
                          for s_ in range(width)] for jj in range(n)],
                        bool)
                    if (guarded & roomy).any():
                        guarded = guarded & roomy
                    elif (feasible & roomy).any():
                        # roomy arms exist only off the prefix-affine
                        # servers: admitting elsewhere beats shedding
                        guarded = feasible & roomy
                    else:
                        admit = False
                j, slot = self.bandit.select(cls, guarded)
            else:
                # scalar CS-UCB select (same score, same first-max tie
                # break as CSUCB.select's argmax over the masked grid)
                b_mean = self._b_mean[cls]
                b_count = self._b_count[cls]
                b_viol = self._b_viol[cls]
                p = self.bandit.p
                delta = p.delta
                neg_theta = -p.theta
                bt = self.bandit.t
                logt = math.log(bt if bt > 2 else 2)
                best = 0.0
                have = False
                j = 0
                slot = 0
                for jj in range(n):
                    base = jj * width
                    mrow = b_mean[jj]
                    crow = b_count[jj]
                    vrow = b_viol[jj]
                    for s_ in range(width):
                        if not feas[base + s_]:
                            continue
                        cnt = crow[s_]
                        if cnt == 0:
                            sc = mrow[s_] + delta * math.sqrt(logt) \
                                + 1e3 + neg_theta * vrow[s_]
                        else:
                            sc = mrow[s_] \
                                + delta * math.sqrt(logt / cnt) \
                                + neg_theta * vrow[s_]
                        if not have or sc > best:
                            best, j, slot, have = sc, jj, s_, True
        else:
            # C1 failover (paper §3.1): no feasible server -> assign to
            # the most resource-rich one, i.e. minimum predicted time, at
            # the nominal tier (the fastest calibrated operating point).
            # predicted_time(alloc=None) inlined from the scan's per-
            # server terms: no tier stretch, so infer is undivided and
            # the margin stretch is an exact ×1.0.
            best_d = math.inf
            j = 0
            for jj in range(n):
                d0 = (txq[jj] + infer0[jj] * infer_r[jj]) \
                    * time_ratio[jj] * SAFETY + err_sqrt[jj]
                if d0 < best_d:
                    best_d, j = d0, jj
            slot = tier_table[j].index(nominals[j]) \
                if nominals[j] in tier_table[j] else 0
            if self.preempt:
                victim = self._find_victim(req, view)
            if victim is not None:
                j = victim.server
                slot = tier_table[j].index(nominals[j]) \
                    if nominals[j] in tier_table[j] else 0
                # KV-resume info: when the victim's server is out of KV
                # *memory* (not just lanes), evicting the lane alone frees
                # nothing — drop the victim's pages so the preemptor's
                # blocks fit, accepting the victim's re-prefill elsewhere
                drop_kv = s_kv[j * width + slot] < 0.0
            elif self.admission:
                # admission control: shedding beats dumping doomed work on
                # the least-bad server — the runtime emits the rejected
                # Outcome (SLO-violation cost) and frees no capacity
                admit = False
        migrate = False
        if admit and 0 <= kv_home < n and j != kv_home \
                and getattr(req, "kv_blocks", 0) > 0:
            migrate = self._migration_pays(req, j, view)
        idx = j * width + slot
        alloc = allocs[j][slot]
        slacks = ConstraintSlacks(time=s_time[idx], compute=s_comp[idx],
                                  bandwidth=s_bw[idx], kv=s_kv[idx])
        self._pending_slacks[req.sid] = slacks
        self._pending_tier[req.sid] = slot
        self._nominal_pred[req.sid] = pred[idx] / SAFETY
        self._last_nominal_infer[req.sid] = infer_nom[idx]
        return Decision(server=j, alloc=alloc,
                        infer_scale=infer_r[j],
                        slacks=slacks, admit=admit,
                        preempt_victim=None if victim is None
                        else victim.sid,
                        preempt_drop_kv=drop_kv,
                        migrate_kv=migrate)

    def _migration_pays(self, req, j, view):
        """Ship preserved pages to the chosen server instead of abandoning
        them? Yes iff the destination can host them and the transfer (at
        the topology's current bottleneck bandwidth, behind its current
        backlog) beats the re-prefill it avoids."""
        totals = getattr(view, "kv_total_blocks", None)
        if totals is None or totals[j] <= 0:
            return False
        spec = view.specs[j]
        need = spec.kv_blocks_needed(req.prompt_tokens, req.output_tokens)
        free = view.kv_free_blocks[j]
        if free is None or free < need:
            return False
        mig_fn = getattr(view, "kv_migration_s", None)
        cost = mig_fn(req, j) if mig_fn is not None else None
        if cost is None:
            return False
        return cost < spec.prefill_time(req.prompt_tokens)

    def _find_victim(self, req, view: ClusterView):
        """A running task worth preempting for `req`, or None.

        Only *doomed* tasks qualify (their estimated finish already misses
        their own deadline — evicting them costs no extra SLO violation),
        and only where `req` could actually meet its deadline once the
        lane is free (transmission + inference at the nominal tier, no
        lane wait). Among qualifying victims, reclaim the most-doomed lane
        first."""
        if not view.running:
            return None
        cls = req.class_id
        best, best_over = None, 0.0
        for tasks in view.running:
            for task in tasks:
                if not task.doomed or task.sid == req.sid:
                    continue
                j = task.server
                d_no_queue = (view.predict_tx(req, j)
                              + view.predict_infer(req, j)
                              * self.infer_ratio[cls, j]) \
                    * self.time_ratio[cls, j] * self.SAFETY
                if d_no_queue > req.deadline:
                    continue
                over = task.finish_est - task.deadline_at
                if over > best_over:
                    best, best_over = task, over
        return best

    def feedback(self, req, out) -> None:
        slacks = self._pending_slacks.pop(req.sid, None)
        nominal = self._nominal_pred.pop(req.sid, None)
        tier_slot = self._pending_tier.pop(req.sid, 0)
        if getattr(out, "rejected", False):
            # the SLO-violation cost of a shed request is a system metric,
            # not an observation: nothing ran, so there is no realized
            # time/energy to learn from (and a zero infer_time would
            # poison the efficiency estimators)
            self._last_nominal_infer.pop(req.sid, None)
            return
        cls, j = req.class_id, out.server

        # realized constraint slack (C1 realized; C2/C3 from decision time)
        time_slack = (req.deadline - out.processing_time) / req.deadline
        f_y = min(time_slack,
                  slacks.compute if slacks else 0.0,
                  slacks.bandwidth if slacks else 0.0,
                  slacks.kv if slacks else 1.0)
        reward = self.bandit.shaped_reward(out.energy / E_SCALE, f_y)
        violation = max(-f_y, 0.0)
        self.bandit.update(cls, j, reward, violation, tier=tier_slot)

        # update learned estimators: per-server efficiency (from pure
        # inference time), per-class residual bias, and error variance
        nom_inf = out.infer_time  # realized
        # realized/nominal inference ratio: EMA, robust to noise
        # (predict_infer is deterministic given the request + allocation,
        # so the ratio isolates the hidden efficiency at any tier)
        self.infer_ratio[cls, j] += 0.1 * (
            out.infer_time / max(self._last_nominal_infer.pop(req.sid, nom_inf),
                                 1e-9) - self.infer_ratio[cls, j])
        if nominal and nominal > 0:
            ratio = out.processing_time / nominal
            self.ratio_count[cls, j] += 1
            n = self.ratio_count[cls, j]
            self.time_ratio[cls, j] += (ratio - self.time_ratio[cls, j]) / n
            err = out.processing_time - nominal * self.time_ratio[cls, j]
            self.err_var[cls, j] += (err * err - self.err_var[cls, j]) \
                / max(n, 1)
        self._refresh_mirrors(cls, j)

    # ------------------------------------------------------------------
    @property
    def regret_trace(self) -> List[float]:
        return self.bandit.regret_trace


def spec_nominal(spec) -> int:
    """Index of a spec's nominal DVFS tier (0 for pre-tier specs)."""
    return getattr(spec, "nominal_tier", 0)
