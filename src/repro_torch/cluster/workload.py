"""Diverse LLM service workload generator (paper §4.2).

10,000 services, deadlines ~ U[2s, 6s], heterogeneous prompt/output lengths
and payload sizes (services carry context documents; the payload term is what
creates cloud uplink congestion, the paper's Fig. 2 observation).
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass(slots=True)
class ServiceRequest:
    sid: int
    arrival: float           # s
    prompt_tokens: int
    output_tokens: int
    deadline: float          # max acceptable processing time D^Δ (s)
    payload_bytes: float     # uplink payload (prompt + context attachments)
    class_id: int = -1

    # filled by the simulator
    finish: float = -1.0
    server: int = -1
    preemptions: int = 0     # times this request's lane was reclaimed
    # paged-KV bookkeeping: which server currently holds this request's
    # KV pages (running, or preserved across a preemption) and how many —
    # a requeue back to `kv_server` resumes decode with zero re-prefill
    kv_server: int = -1
    kv_blocks: int = 0
    # shared-prefix identity: requests from the same system-prompt pool
    # carry the same `prefix_id` and share their first `prefix_tokens`
    # prompt tokens — a KV-modeled server that already holds that prefix
    # serves them without re-prefilling it (-1/0: no shared prefix)
    prefix_id: int = -1
    prefix_tokens: int = 0

    @property
    def processing_time(self) -> float:
        return self.finish - self.arrival if self.finish >= 0 else float("inf")

    @property
    def success(self) -> bool:
        return self.finish >= 0 and self.processing_time <= self.deadline


def generate_workload(n_services: int = 10_000, rate: float = 10.0,
                      seed: int = 0, scenario=None) -> List[ServiceRequest]:
    """Arrivals at `rate` req/s with diverse requirements.

    `scenario` (a `repro_torch.core.runtime.Scenario` instance or registered
    name, e.g. ``"burst"``/``"diurnal"``/``"trace"``) shapes *when*
    services arrive; `None` keeps the paper's stationary Poisson process.
    Per-request requirements are drawn identically either way — scenarios
    that override `shape_requests` (e.g. ``"kv-pressure"``) then transform
    those base draws in place, from their own rng substream — so two
    scenarios at the same seed start from the same services.
    """
    rng = np.random.default_rng(seed)
    # the Poisson gaps are always drawn so the requirement draws below sit
    # at the same rng state for every scenario (same services, new timing)
    gaps = rng.exponential(1.0 / rate, size=n_services)
    if scenario is not None:
        from repro_torch.core.runtime import Scenario, make_scenario
        if isinstance(scenario, str):
            scenario = make_scenario(scenario)
        if (type(scenario).arrival_times is Scenario.arrival_times
                and type(scenario).shape_requests
                is Scenario.shape_requests):
            # stationary Poisson with unshaped requests (incl. scenarios
            # that only inject bandwidth events, e.g. bwdrop): keep the
            # baseline arrivals so the scenario's effect can be isolated
            # arrival-for-arrival
            scenario = None
    arrivals = (
        np.cumsum(gaps)
        if scenario is None
        or type(scenario).arrival_times is Scenario.arrival_times
        else scenario.arrival_times(
            n_services, rate, np.random.default_rng([seed, 0x5CEA])))
    prompt = np.clip(rng.lognormal(5.0, 0.8, n_services), 32, 2048).astype(int)
    out = np.clip(rng.lognormal(2.8, 0.6, n_services), 4, 96).astype(int)
    deadline = rng.uniform(2.0, 6.0, n_services)
    payload = rng.uniform(0.7e6, 6.7e6, n_services)  # 0.7–6.7 MB context docs
    # bulk-convert once (C loop) instead of one numpy-scalar unboxing per
    # field per request — at 10^6 services the construction loop below is
    # the whole cost of workload generation
    services = [
        ServiceRequest(sid=i, arrival=a, prompt_tokens=p,
                       output_tokens=o, deadline=d, payload_bytes=b)
        for i, (a, p, o, d, b) in enumerate(zip(
            arrivals.tolist(), prompt.tolist(), out.tolist(),
            deadline.tolist(), payload.tolist()))
    ]
    if scenario is not None:
        scenario.shape_requests(services,
                                np.random.default_rng([seed, 0x5D01]))
    return services


# --------------------------------------------------------------------------
# Service classes — PerLLM is *personalized*: the bandit learns per class.
# --------------------------------------------------------------------------

_PROMPT_EDGES = (128, 512)
_DEADLINE_EDGES = (3.0, 4.5)


_P_LO, _P_HI = _PROMPT_EDGES
_D_LO, _D_HI = _DEADLINE_EDGES
_D_BINS = len(_DEADLINE_EDGES) + 1


def classify(req: ServiceRequest) -> int:
    # unrolled histogram binning over the two edge tuples (this runs once
    # per request per simulation, so no generator/sum machinery)
    p = (req.prompt_tokens > _P_LO) + (req.prompt_tokens > _P_HI)
    d = (req.deadline > _D_LO) + (req.deadline > _D_HI)
    return p * _D_BINS + d


N_CLASSES = (len(_PROMPT_EDGES) + 1) * (len(_DEADLINE_EDGES) + 1)
