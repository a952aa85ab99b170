"""Baseline schedulers the paper compares against (§4.1).

All three are `SchedulingPolicy` implementations: they return `Decision`
objects and never touch the view's residuals themselves (the runtime
commits between `assign` calls, so within-slot load observations still
reflect the policy's own earlier placements).

FineInfer [He et al., EuroMLSys'24] — cloud-only with *deferred continuous
batching*: requests are held and dispatched at batching-window boundaries
(expressed as `Decision.defer_until`, applied by the runtime).

AGOD [Du et al., TMC'24] — edge-only; the diffusion-model + DRL offloading
policy is represented by its decision rule: an ε-greedy learned value per
(class, edge) with least-loaded tie-breaking (the published behavior:
learns edge selection, cannot use the cloud).

RewardlessGuidance [Fang et al., VTC'23] — edge-cloud active inference:
picks the server minimizing expected free energy = normalized *nominal*
expected completion time + normalized expected energy. No reward learning
(that is the method's premise) — so it cannot adapt to hidden efficiency or
congestion dynamics, which is exactly what the paper exploits.

All three baselines are *allocation-blind*: their Decisions carry the
default nominal `Allocation` (nominal DVFS tier, full lane/uplink shares),
because none of the published methods models per-request compute
allocation. On a tiered testbed that is precisely the energy PerLLM's
(class, server, tier) arm space gets to claw back.
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.cluster.workload import N_CLASSES
from repro_torch.core.api import ClusterView, Decision, SchedulingPolicy, \
    register_policy


@register_policy("fineinfer")
class FineInfer(SchedulingPolicy):
    name = "FineInfer"

    def __init__(self, n_servers: int, batch_window: float = 1.0, **_):
        self.n_servers = n_servers
        self.cloud = n_servers - 1          # convention: last server = cloud
        self.batch_window = batch_window

    def assign(self, req, view: ClusterView) -> Decision:
        # deferred batching: requests are held until the next batching
        # window boundary before dispatch
        defer = math.ceil(req.arrival / self.batch_window) * self.batch_window
        return Decision(server=self.cloud, defer_until=defer)


@register_policy("agod")
class AGOD(SchedulingPolicy):
    name = "AGOD"

    def __init__(self, n_servers: int, epsilon: float = 0.08, seed: int = 0,
                 **_):
        self.n_edges = n_servers - 1
        self.eps = epsilon
        self.rng = np.random.default_rng(seed)
        self.value = np.zeros((N_CLASSES, self.n_edges))
        self.count = np.zeros((N_CLASSES, self.n_edges), np.int64)

    def assign(self, req, view: ClusterView) -> Decision:
        if self.rng.uniform() < self.eps:
            j = int(self.rng.integers(self.n_edges))
        else:
            load = np.array([min(view.lane_free[e]) for e
                             in range(self.n_edges)])
            score = self.value[req.class_id] - 0.2 * (load - view.t)
            j = int(np.argmax(score))
        return Decision(server=j)

    def feedback(self, req, out) -> None:
        if out.server >= self.n_edges:
            return
        cls = req.class_id
        r = 1.0 if out.success else -1.0
        self.count[cls, out.server] += 1
        n = self.count[cls, out.server]
        self.value[cls, out.server] += (r - self.value[cls, out.server]) / n


@register_policy("rewardless-guidance")
class RewardlessGuidance(SchedulingPolicy):
    name = "RewardlessGuidance"

    def __init__(self, n_servers: int, w_time: float = 0.6,
                 w_energy: float = 0.4, belief_rate: float = 0.006,
                 temp: float = 0.5, seed: int = 0, **_):
        self.n_servers = n_servers
        self.w_time = w_time
        self.w_energy = w_energy
        # active inference keeps an *epistemic* (exploration) drive: actions
        # are sampled from the EFE softmax rather than argmin'd, and the
        # drive never anneals (there is no reward signal to converge on)
        self.temp = temp
        self.rng = np.random.default_rng(seed)
        # active-inference state belief: slow EMA of observed lag vs the
        # nominal model (beliefs about hidden state, not reward learning)
        self.belief_rate = belief_rate
        self.lag_belief = np.zeros(n_servers)

    def _expected_energy(self, req, j: int, view: ClusterView) -> float:
        spec = view.specs[j]
        t_inf = view.predict_infer(req, j)
        t_tx = req.payload_bytes * 8.0 / spec.bandwidth
        # nominal-tier dynamic energy — the one formula runtimes charge
        return spec.infer_energy(t_inf) + spec.tx_power * t_tx

    def assign(self, req, view: ClusterView) -> Decision:
        # expected free energy from *static nominal* models (rewardless:
        # no learning, no live congestion state — the method's premise)
        efe = []
        for j in range(self.n_servers):
            spec = view.specs[j]
            t_stat = (view.predict_infer(req, j)
                      + req.payload_bytes * 8.0 / spec.bandwidth
                      + self.lag_belief[j])
            t = t_stat / max(req.deadline, 1e-9)
            e = self._expected_energy(req, j, view) / 500.0
            efe.append(self.w_time * t + self.w_energy * e)
        efe = np.asarray(efe)
        p = np.exp(-(efe - efe.min()) / self.temp)
        p /= p.sum()
        return Decision(server=int(self.rng.choice(self.n_servers, p=p)))

    def feedback(self, req, out) -> None:
        j = out.server
        spec_nominal = out.infer_time  # realized; belief tracks extra lag
        lag = max(out.processing_time - spec_nominal, 0.0)
        self.lag_belief[j] += self.belief_rate * (lag - self.lag_belief[j])


def make_baselines(n_servers: int, seed: int = 0):
    return [FineInfer(n_servers), AGOD(n_servers, seed=seed),
            RewardlessGuidance(n_servers)]
