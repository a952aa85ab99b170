"""Network models: per-link bandwidth topology and the legacy per-server
bandwidth model (paper §4.1).

`LinkTopology` is the runtime's network: named directed links (user→edge,
user→cloud, edge→cloud backhaul, ...), each with a capacity, an
*independent* fluctuation substream, and a scenario scale overlay; every
server is reached over a serial path of links. A transfer occupies all
links on its path, serialized per link, and its rate is the path's
bottleneck — so a congested shared uplink slows every server behind it,
which is what lets policies route around a slow *link* rather than a
"slow server".

Fluctuation streams are drawn per (link, sample index) from a dedicated
seed sequence, so a link's factor trace is invariant to how many other
links exist and to how often the others are sampled. (The legacy
`BandwidthModel` draws its uniform noise from one shared RNG, coupling
every link's trace to the cluster size and sampling order; it survives
unchanged as the bit-exact shim behind `LinkTopology.degenerate`, guarded
by the frozen golden tests.)

Factors are resampled on a periodic `BandwidthChange` stream (see
`repro_torch.core.runtime`), and scenario events may overlay multiplicative
scales per server *or per named link* (congestion/outage windows) on
top.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np


class BandwidthModel:
    """Per-slot multiplicative bandwidth factor for each server link.

    Legacy model: one shared RNG for every link's noise draw (`factor(t,
    j)` therefore depends on how many factors were sampled before it).
    Kept bit-exact as the degenerate topology's factor source — the frozen
    golden tests pin its stream. New topologies use `LinkTopology`'s
    per-link substreams instead.
    """

    def __init__(self, fluctuating: bool = False, amplitude: float = 0.2,
                 seed: int = 0):
        self.fluctuating = fluctuating
        self.amplitude = amplitude
        self.seed = seed
        self._rng = np.random.default_rng(seed)

    def factor(self, t_slot: int, server_idx: int) -> float:
        if not self.fluctuating:
            return 1.0
        # smooth-ish fluctuation: sinusoid + noise, clipped to ±amplitude
        base = np.sin(0.37 * t_slot + 2.1 * server_idx)
        noise = self._rng.uniform(-1.0, 1.0)
        f = 1.0 + self.amplitude * float(np.clip(0.6 * base + 0.4 * noise,
                                                 -1.0, 1.0))
        return f

    def factors(self, t_slot: int, n_servers: int) -> List[float]:
        """All links' factors for one sample instant (stable draw order:
        server 0 first — both runtimes use this so RNG streams agree)."""
        return [self.factor(t_slot, j) for j in range(n_servers)]


@dataclasses.dataclass(frozen=True)
class Link:
    """One directed network link.

    `capacity` is the link's nominal rate in bits/s; `fluctuating` links
    draw a ±`amplitude` multiplicative factor per sample instant from
    their own substream (index-keyed, so the trace is invariant to the
    rest of the topology).
    """

    name: str
    capacity: float               # bits/s
    fluctuating: bool = False
    amplitude: float = 0.2


class LinkTopology:
    """Named links + per-server serial paths, with observable state.

    The runtime owns the mutable per-link state (`free_at` backlog and
    scenario `scale` overlays); the topology owns the static structure and
    the fluctuation streams. `paths[j]` lists the link names a request
    traverses to reach server `j`; the effective bandwidth of the path is
    its bottleneck `capacity × factor × scale`.
    """

    def __init__(self, links: Sequence[Link], paths: Sequence[Sequence[str]],
                 seed: int = 0, bandwidth: Optional[BandwidthModel] = None):
        self.links: Dict[str, Link] = {lk.name: lk for lk in links}
        if len(self.links) != len(links):
            raise ValueError("duplicate link names in topology")
        self.paths: List[List[str]] = [list(p) for p in paths]
        for p in self.paths:
            for name in p:
                if name not in self.links:
                    raise KeyError(f"path references unknown link {name!r}")
            if not p:
                raise ValueError("every server needs at least one link")
        self.seed = seed
        self._index = {name: i for i, name in enumerate(self.links)}
        # the degenerate shim delegates factor sampling to the legacy
        # shared-RNG model so the frozen golden streams are untouched
        self._legacy = bandwidth

    # ---------------- structure ------------------------------------------
    @property
    def n_servers(self) -> int:
        return len(self.paths)

    @property
    def link_names(self) -> List[str]:
        return list(self.links)

    def server_link(self, j: int) -> str:
        """The server's dedicated access link (first hop of its path) —
        the target of legacy server-indexed `BandwidthChange.scale`."""
        return self.paths[j][0]

    @property
    def is_degenerate(self) -> bool:
        """One private link per server: the legacy per-server model."""
        return self._legacy is not None

    # ---------------- fluctuation ----------------------------------------
    def factor(self, name: str, k: int) -> float:
        """Link `name`'s multiplicative factor at sample instant `k`.

        Per-link substream: the draw is keyed by (seed, link index, k), so
        the trace neither depends on the cluster size nor on how many
        other factors were sampled first — the RNG-coupling fix over
        `BandwidthModel.factor`.
        """
        link = self.links[name]
        if not link.fluctuating:
            return 1.0
        idx = self._index[name]
        base = np.sin(0.37 * k + 2.1 * idx)
        noise = np.random.default_rng([self.seed, idx, k]).uniform(-1.0, 1.0)
        return 1.0 + link.amplitude * float(
            np.clip(0.6 * base + 0.4 * noise, -1.0, 1.0))

    def factors(self, k: int) -> Dict[str, float]:
        """All links' factors at sample instant `k`."""
        if self._legacy is not None:
            legacy = self._legacy.factors(k, self.n_servers)
            return {self.server_link(j): legacy[j]
                    for j in range(self.n_servers)}
        return {name: self.factor(name, k) for name in self.links}

    # ---------------- path queries (pure; state is passed in) -------------
    def path_bandwidth(self, j: int, factors: Dict[str, float],
                       scale: Dict[str, float]) -> float:
        """Bottleneck bits/s of server j's path under factors × scales."""
        return min(self.links[lk].capacity * factors.get(lk, 1.0)
                   * scale.get(lk, 1.0) for lk in self.paths[j])

    def path_free_at(self, j: int, free_at: Dict[str, float]) -> float:
        """Earliest time every link on server j's path is free."""
        return max(free_at[lk] for lk in self.paths[j])

    def migration_path(self, src: int, dst: int) -> List[str]:
        """Links a server-to-server KV migration occupies: the ordered
        deduplicated union of both servers' paths. With user-rooted paths
        this is the conservative route (src egress + dst ingress; a
        shared backhaul appears once) — a migration contends with every
        transfer to either endpoint, which is the cost policies weigh."""
        path: List[str] = []
        for name in self.paths[src] + self.paths[dst]:
            if name not in path:
                path.append(name)
        return path

    def migration_bandwidth(self, src: int, dst: int,
                            factors: Dict[str, float],
                            scale: Dict[str, float]) -> float:
        """Bottleneck bits/s of the src->dst migration path."""
        return min(self.links[lk].capacity * factors.get(lk, 1.0)
                   * scale.get(lk, 1.0)
                   for lk in self.migration_path(src, dst))

    def server_factor(self, j: int, nominal_bw: float,
                      factors: Dict[str, float],
                      scale: Dict[str, float]) -> float:
        """Effective per-server bandwidth factor: path bottleneck over the
        server's nominal uplink. The dedicated-link fast path multiplies
        factor × scale directly — the exact float ops of the legacy
        per-server model, which keeps degenerate runs bit-exact."""
        path = self.paths[j]
        if len(path) == 1 and self.links[path[0]].capacity == nominal_bw:
            name = path[0]
            return factors.get(name, 1.0) * scale.get(name, 1.0)
        return self.path_bandwidth(j, factors, scale) / nominal_bw

    def book(self, j: int, t: float, payload_bytes: float,
             factors: Dict[str, float], scale: Dict[str, float],
             free_at: Dict[str, float]) -> tuple:
        """Serialize one transfer to server j over its path.

        Returns `(tx_start, tx_dur)` and advances every path link's
        `free_at` to the transfer's end (a transfer occupies the whole
        path — the fluid bottleneck model).
        """
        tx_start = max(t, self.path_free_at(j, free_at))
        bw = self.path_bandwidth(j, factors, scale)
        tx_dur = payload_bytes * 8.0 / max(bw, 1e-9)
        end = tx_start + tx_dur
        for lk in self.paths[j]:
            free_at[lk] = end
        return tx_start, tx_dur

    # ---------------- factories ------------------------------------------
    @classmethod
    def degenerate(cls, specs: Sequence,
                   bandwidth: Optional[BandwidthModel] = None,
                   ) -> "LinkTopology":
        """One private link per server — the legacy per-server model.

        Factor sampling delegates to the wrapped `BandwidthModel` (shared
        RNG and all), so runs through the degenerate topology are
        bit-exact with the pre-topology runtime.
        """
        model = bandwidth or BandwidthModel()
        links = [Link(name=f"user-{getattr(s, 'name', f'srv{j}')}",
                      capacity=s.bandwidth, fluctuating=model.fluctuating,
                      amplitude=model.amplitude)
                 for j, s in enumerate(specs)]
        return cls(links, [[lk.name] for lk in links], seed=model.seed,
                   bandwidth=model)

    @classmethod
    def edge_cloud(cls, specs: Sequence, fluctuating: bool = False,
                   amplitude: float = 0.2, seed: int = 0,
                   backhaul_scale: float = 1.5) -> "LinkTopology":
        """The paper's deployment as an explicit link graph.

        Each edge server gets a private `user-edge{j}` access link at its
        spec bandwidth; cloud servers are reached over *two* serial hops —
        the user's `user-cloud` WAN access plus the shared `edge-cloud`
        metro/backhaul aggregation link (capacity `backhaul_scale ×` the
        summed cloud access bandwidth, so it only binds under scenario
        overlays such as a cloud-uplink outage). All links fluctuate on
        independent substreams when `fluctuating` is set.
        """
        links: List[Link] = []
        paths: List[List[str]] = []
        clouds = [j for j, s in enumerate(specs)
                  if getattr(s, "kind", "edge") == "cloud"]
        cloud_bw = sum(specs[j].bandwidth for j in clouds)
        backhaul = Link("edge-cloud", backhaul_scale * max(cloud_bw, 1.0),
                        fluctuating=fluctuating, amplitude=amplitude)
        for j, s in enumerate(specs):
            if j in clouds:
                # a single cloud keeps the canonical "user-cloud" name
                # (what scenario link_scale overlays target); multi-cloud
                # testbeds get indexed names — the shared backhaul is
                # still on every cloud path, so outages bite regardless
                name = "user-cloud" if len(clouds) == 1 \
                    else f"user-cloud{j}"
                links.append(Link(name, s.bandwidth, fluctuating=fluctuating,
                                  amplitude=amplitude))
                paths.append([name, backhaul.name])
            else:
                name = f"user-edge{j}"
                links.append(Link(name, s.bandwidth, fluctuating=fluctuating,
                                  amplitude=amplitude))
                paths.append([name])
        if clouds:
            links.append(backhaul)
        return cls(links, paths, seed=seed)


class LinkStateMixin:
    """The mutable link state a runtime owns on top of a `LinkTopology`:
    per-link serialized backlog (`link_free`) and scenario scale overlays
    (`link_scale`). Shared by the simulator runtimes and the live
    `PerLLMServer` so overlay/observability semantics cannot diverge."""

    def init_link_state(self, topology: LinkTopology) -> None:
        self.topology = topology
        self.link_free: Dict[str, float] = {n: 0.0 for n in topology.links}
        self.link_scale: Dict[str, float] = {n: 1.0 for n in topology.links}

    def apply_bandwidth_scales(self, ev) -> None:
        """Fold a `BandwidthChange`'s overlays into `link_scale` (legacy
        per-server scales land on the server's access link; named link
        scales apply where the topology knows the link)."""
        if ev.scale:
            for j, s in ev.scale.items():
                self.link_scale[self.topology.server_link(j)] = s
        if ev.link_scale:
            for name, s in ev.link_scale.items():
                if name in self.link_scale:
                    self.link_scale[name] = s

    def link_view_kwargs(self, t: float,
                         link_factors: Dict[str, float]) -> dict:
        """Per-link observability for `ClusterView`: observed bandwidth and
        serialized backlog per named link, plus each server's path."""
        topo = self.topology
        return dict(
            link_bw={n: topo.links[n].capacity * link_factors.get(n, 1.0)
                     * self.link_scale[n] for n in topo.links},
            link_queue={n: max(f - t, 0.0)
                        for n, f in self.link_free.items()},
            paths=topo.paths)


_TOPOLOGIES = {
    "degenerate": LinkTopology.degenerate,
    "edge-cloud": LinkTopology.edge_cloud,
}


def make_topology(name: str, specs: Sequence, **kwargs) -> LinkTopology:
    """Construct a named topology (`degenerate` or `edge-cloud`)."""
    key = name.lower().replace("_", "-")
    if key not in _TOPOLOGIES:
        raise KeyError(f"unknown topology {name!r}; available: "
                       + ", ".join(sorted(_TOPOLOGIES)))
    return _TOPOLOGIES[key](specs, **kwargs)
