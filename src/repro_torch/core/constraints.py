"""Constraint-satisfaction mechanism (paper Eq. 2 constraints + Eq. 3 f(y)).

C1: per-service processing time within its requirement D^Δ
C2: assigned compute within the server's available compute
C3: assigned uplink bandwidth within the server's available bandwidth
C4: exactly one server per service (structural — enforced by the action
    space, every action assigns exactly one server).
C5: assigned KV-cache blocks within the server's free block pool — only
    evaluated when the runtime models KV memory (`view.kv_total_blocks`);
    otherwise the slack is a vacuous 1.0 and nothing changes.

`f(y) = min(normalized slacks)`; a scheme satisfies all constraints iff
f(y) >= 0. The same function is used (a) as the feasibility filter before
arm selection and (b) as the reward shaping term λ·f(y) in Eq. 4.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.cluster.workload import ServiceRequest
from repro_torch.core.api import Allocation, ClusterView


@dataclasses.dataclass(frozen=True)
class ConstraintSlacks:
    time: float        # (D^Δ − D̂) / D^Δ
    compute: float     # (C_max − ΣC) / C_max
    bandwidth: float   # (B_max − ΣB) / B_max
    kv: float = 1.0    # (KV_free − KV_need) / KV_total; 1.0 = unmodeled

    @property
    def f(self) -> float:
        """Eq. 3: minimum normalized slack."""
        return min(self.time, self.compute, self.bandwidth, self.kv)

    @property
    def satisfied(self) -> bool:
        return self.f >= 0.0


def evaluate_constraints(req: ServiceRequest, j: int, view: ClusterView,
                         predicted_time: Optional[float] = None,
                         alloc: Optional[Allocation] = None,
                         ) -> ConstraintSlacks:
    """Normalized slacks for assigning `req` to server `j` given residuals.

    `predicted_time` lets CS-UCB substitute its *learned* processing-time
    estimate for C1; the default is the nominal analytic predictor.
    `alloc` evaluates feasibility *at that allocation*: a slow DVFS tier
    stretches both the C1 completion estimate and the C2 lane-seconds the
    request needs — a slow tier that still fits is feasible (and cheaper),
    which is exactly the arm space the tier-aware CS-UCB searches.
    """
    spec = view.specs[j]
    d_hat = (view.predict_total(req, j, alloc) if predicted_time is None
             else predicted_time)
    time_slack = (req.deadline - d_hat) / req.deadline

    # C2 — compute: lane-seconds already committed within the deadline
    # horizon vs. available lane-seconds. A slowed (low-tier / sub-lane)
    # allocation occupies its lane for the stretched window, so it needs
    # proportionally more of the horizon.
    horizon = req.deadline
    lanes = view.lane_free[j]
    committed = sum(max(lf - view.t, 0.0) for lf in lanes)
    capacity = spec.max_concurrency * horizon
    need = view.predict_infer(req, j, alloc)
    compute_slack = (capacity - committed - need) / capacity

    # C3 — bandwidth: uplink backlog + this payload vs. deliverable bits
    # within the deadline.
    backlog_s = max(view.uplink_free_at[j] - view.t, 0.0)
    bw = spec.bandwidth * view.bw_factor[j]
    need_bits = req.payload_bytes * 8.0
    cap_bits = bw * horizon
    used_bits = backlog_s * bw
    bw_slack = (cap_bits - used_bits - need_bits) / cap_bits

    # C5 — KV memory: blocks this request would pin (prompt + decode)
    # vs the server's free pool. A request already holding pages on j
    # (preserved across a preemption) needs nothing new — resuming is free.
    kv_slack = 1.0
    totals = view.kv_total_blocks
    if totals is not None and totals[j] > 0:
        if getattr(req, "kv_server", -1) == j \
                and getattr(req, "kv_blocks", 0) > 0:
            kv_need = 0
        else:
            kv_need = spec.kv_blocks_needed(req.prompt_tokens,
                                            req.output_tokens)
            # shared-prefix pages already resident on j shrink the
            # request's unique footprint — a prefix hit charges only the
            # suffix blocks, so the slack reflects what admission will
            # actually claim
            hit_fn = getattr(view, "prefix_hit_tokens", None)
            if hit_fn is not None:
                kv_need -= hit_fn(req, j) // max(spec.kv_block_tokens, 1)
        kv_slack = (view.kv_free_blocks[j] - kv_need) / totals[j]

    return ConstraintSlacks(time=time_slack, compute=compute_slack,
                            bandwidth=bw_slack, kv=kv_slack)
