"""CS-UCB: Constraint-Satisfaction Upper Confidence Bound (paper Alg. 1).

Combinatorial MAB view (§3.2): the per-slot assignment of all arriving
services is a *super arm*; each base action a = (service class, server,
DVFS tier) — the paper's joint "service scheduling and resource
allocation" decision. With a single (nominal) tier this degenerates to the
classic (class, server) arm space. The algorithm keeps, per base action:

    R̄(a)     — running mean of the shaped reward (Eq. 4)
    L(a, t)  — pull count
    V̄(a)     — running mean violation severity (drives the penalty P(t))

and selects, among constraint-satisfying actions,

    a_t = argmax R̄(a) + δ·sqrt(ln t / L(a,t)) + θ·P(a,t)      (Eq. 6)

with P(a,t) = −V̄(a) (penalty proportional to the observed degree of
violation, §3.3). The approximate regret (Eq. 5) is tracked against the
best-in-hindsight arm per class with approximation coefficients α, β < 1.

Reward shaping note: Eq. 4's r = −E_norm + λ·f(y) enters with f(y) clipped
into [−1, 0] — violations are penalized in proportion to their severity,
but *surplus* slack earns nothing. Eq. 1 minimizes energy subject to the
constraints; rewarding surplus slack would make the bandit prefer the
fastest feasible allocation over the cheapest one, which is exactly
backwards for DVFS tier selection (a slower tier deliberately spends slack
to save energy).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple, Union

import numpy as np

from repro_torch.obs.trace import KIND_ARM


@dataclasses.dataclass
class CSUCBParams:
    lam: float = 1.0        # λ — weight of f(y) inside the reward (Eq. 4)
    alpha: float = 0.9      # α — approximation coefficient (Eq. 5)
    beta: float = 0.95      # β — approximation coefficient (Eq. 5)
    delta: float = 0.35     # δ — exploration strength (Eq. 6)
    theta: float = 1.0      # θ — penalty weight (Eq. 6 / Eq. 7)
    optimistic_init: float = 0.5


class CSUCB:
    """Per-(class, server, tier) UCB statistics with constraint shaping.

    `n_tiers=1` (the default) is the placement-only arm space; masks and
    arm indices may then be plain per-server vectors/ints, so existing
    call sites are unchanged. With `n_tiers > 1` masks are
    (n_servers, n_tiers) boolean grids and `select` returns the
    (server, tier) pair.
    """

    def __init__(self, n_classes: int, n_servers: int,
                 params: Optional[CSUCBParams] = None, seed: int = 0,
                 n_tiers: int = 1):
        self.p = params or CSUCBParams()
        self.n_classes = n_classes
        self.n_servers = n_servers
        self.n_tiers = n_tiers
        shape = (n_classes, n_servers, n_tiers)
        self.mean = np.full(shape, self.p.optimistic_init, np.float64)
        self.count = np.zeros(shape, np.int64)
        self.violation = np.zeros(shape, np.float64)
        self.t = 0
        # regret accounting (Eq. 5)
        self.cum_reward = 0.0
        self.cum_best = 0.0
        self.regret_trace: List[float] = []
        # optional repro_torch.obs.TraceRecorder: every `update` (the single
        # arm-pull point) lands one ARM row — pull index, arm coords,
        # reward, violation — for the report CLI's bandit timeline
        self.trace = None

    # ------------------------------------------------------------------
    def _grid_mask(self, feasible_mask: np.ndarray) -> np.ndarray:
        mask = np.asarray(feasible_mask, bool)
        if mask.ndim == 1:
            if self.n_tiers != 1:
                raise ValueError(
                    f"per-server mask of shape {mask.shape} given, but the "
                    f"arm space has {self.n_tiers} tiers — pass a "
                    f"(n_servers, n_tiers) mask")
            mask = mask[:, None]
        return mask

    def ucb(self, cls: int, feasible_mask: np.ndarray) -> np.ndarray:
        """Eq. 6 scores for one service class; −inf outside the mask.

        Pure scoring: bandit time `t` only advances in `update()`, so
        diagnostics (or double scoring) never perturb exploration. The
        returned array matches the mask's shape ((n_servers,) masks come
        back as per-server scores)."""
        mask = self._grid_mask(feasible_mask)
        logt = math.log(max(self.t, 2))
        cnt = np.maximum(self.count[cls], 1)
        explore = self.p.delta * np.sqrt(logt / cnt)
        bonus = np.where(self.count[cls] == 0, 1e3, 0.0)  # force first pull
        penalty = -self.p.theta * self.violation[cls]
        score = self.mean[cls] + explore + bonus + penalty
        score = np.where(mask, score, -np.inf)
        if np.asarray(feasible_mask).ndim == 1:
            return score[:, 0]
        return score

    def select(self, cls: int,
               feasible_mask: np.ndarray) -> Union[int, Tuple[int, int]]:
        """Best arm under Eq. 6. A per-server mask returns the server
        index; a (server, tier) grid mask returns the (server, tier)
        pair."""
        grid = np.asarray(feasible_mask).ndim > 1
        mask = self._grid_mask(feasible_mask)
        score = self.ucb(cls, mask)
        if not np.isfinite(score).any():
            # no feasible arm: fall back to least-violating arm (paper: the
            # service is assigned to the most resource-rich server)
            score = self.mean[cls] - self.p.theta * self.violation[cls]
        j, k = np.unravel_index(int(np.argmax(score)), score.shape)
        return (int(j), int(k)) if grid else int(j)

    # ------------------------------------------------------------------
    def shaped_reward(self, energy_norm: float, f_y: float) -> float:
        """Eq. 4: r = −E_norm + λ·f(y), with f(y) clipped into [−1, 0]
        (violations penalized, surplus slack not rewarded — see module
        docstring)."""
        f = f_y if f_y > -1.0 else -1.0
        if f > 0.0:
            f = 0.0
        return -energy_norm + self.p.lam * f

    def update(self, cls: int, server: int, reward: float,
               violation_severity: float, tier: int = 0) -> None:
        self.t += 1
        a = (cls, server, tier)
        self.count[a] += 1
        n = self.count[a]
        self.mean[a] += (reward - self.mean[a]) / n
        v = self.violation[a]
        self.violation[a] = v + (max(violation_severity, 0.0) - v) / n
        if violation_severity > 0.0 and self.n_tiers > 1:
            # congestion coupling: a C1 violation is a *server*-level event
            # (lane backlog from every tier's bookings), so the penalty
            # P(t) bleeds into the sibling tier arms of (cls, server) at
            # half weight — otherwise slow tiers keep looking safe while
            # their stretched bookings doom later nominal-tier requests on
            # the same host
            for k in range(self.n_tiers):
                if k == tier:
                    continue
                s = (cls, server, k)
                cnt = max(int(self.count[s]), 1)
                self.violation[s] += \
                    (violation_severity - self.violation[s]) / (2 * cnt)

        # Eq. 5 approximate regret vs best-in-hindsight arm of this class
        best = float(np.max(self.mean[cls]))
        self.cum_best += self.p.alpha * self.p.beta * best
        self.cum_reward += reward
        self.regret_trace.append(self.cum_best - self.cum_reward)

        if self.trace is not None:
            # ARM row: sid = pull index (the bandit's clock), energy =
            # reward, value = violation severity
            self.trace.append(KIND_ARM, self.t, float(self.t),
                              float(self.t), server, cls, tier,
                              reward, violation_severity)

    # ------------------------------------------------------------------
    @property
    def regret(self) -> float:
        return self.regret_trace[-1] if self.regret_trace else 0.0

    def regret_bound(self) -> float:
        """Eq. 7: sqrt(2·|A|·log L) + θ·P̄ with L = max pulls.

        |A| is derived from the live arm-space shape (classes × servers ×
        tiers), not hardcoded — expanding the arm space (e.g. enabling
        DVFS tiers) widens the bound accordingly."""
        big_l = max(int(self.count.max()), 2)
        p_bar = float(np.mean(self.violation))
        return math.sqrt(2.0 * self.mean.size
                         * math.log(big_l)) + self.p.theta * p_bar
