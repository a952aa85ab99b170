"""Metrics registry: counters, gauges, fixed-bucket histograms.

One canonical key namespace shared by the simulator (`SimResult`), the
live server (`PerLLMServer.stats`), and the serving engine
(`ServingEngine.stats()`). Keys are labeled by arbitrary string/int
dimensions (server, class, tier); an unlabeled key is the plain scalar
counter.

The sim runtimes keep their hot-path counters *in* the registry via
:func:`counter_attr` — a class-level property backed by a single
unlabeled registry slot, so existing ``self.n_rejected += 1`` call sites
work unchanged while `SimResult` / `stats()` read straight out of the
registry. The slot holds whatever Python number was assigned (int or
float), so floating-point accumulation order — and therefore
bit-identity with the pre-registry code — is preserved.

Deprecated key aliases: the pre-unification stats dictionaries used a
second naming convention (``served`` vs ``n_served``, ``prefix_hits`` vs
``n_prefix_hits``). :data:`DEPRECATED_ALIASES` maps old → canonical and
:func:`with_aliases` adds the old spellings back onto a canonical stats
dict for one release; new code should read only canonical keys.
"""
from __future__ import annotations

from bisect import bisect_right
from typing import Dict, Iterable, List, Tuple

import numpy as np

#: old key -> canonical key. The old spellings are served by
#: :func:`with_aliases` for one release and then removed.
DEPRECATED_ALIASES = {
    "served": "n_served",
    "rejected": "n_rejected",
    "preempted": "n_preempted",
    "kv_migrations": "n_kv_migrations",
    "prefix_hits": "n_prefix_hits",
    "prefix_tokens_reused": "kv_prefill_tokens_saved",
    "prefills": "n_prefills",
    "deadline_met": "admitted_success_rate",
    "mean_latency": "avg_processing_time",
    "per_server": "per_server_served",
}


def with_aliases(stats: Dict[str, object]) -> Dict[str, object]:
    """Return ``stats`` plus the deprecated old-name aliases for every
    canonical key present."""
    out = dict(stats)
    for old, new in DEPRECATED_ALIASES.items():
        if new in out and old not in out:
            out[old] = out[new]
    return out


def _label_key(labels: dict) -> Tuple[Tuple[str, object], ...]:
    return tuple(sorted(labels.items()))


class MetricsRegistry:
    """Counters / gauges / fixed-bucket histograms keyed by
    ``(name, sorted-label-tuple)``."""

    def __init__(self) -> None:
        self._counters: Dict[tuple, float] = {}
        self._gauges: Dict[tuple, float] = {}
        self._hist_edges: Dict[str, List[float]] = {}
        # (name, labels) -> [counts(list, len(edges)+1), sum, n]
        self._hists: Dict[tuple, list] = {}

    # -- counters ------------------------------------------------------
    def inc(self, name: str, amount=1, **labels) -> None:
        k = (name, _label_key(labels))
        self._counters[k] = self._counters.get(k, 0) + amount

    def put_scalar(self, name: str, value) -> None:
        """Set the unlabeled counter slot (used by :func:`counter_attr`)."""
        self._counters[(name, ())] = value

    def put(self, name: str, value, **labels) -> None:
        """Idempotently set a labeled counter (snapshot semantics — safe
        to call from a `stats` path that may run repeatedly)."""
        self._counters[(name, _label_key(labels))] = value

    def get_scalar(self, name: str, default=0):
        return self._counters.get((name, ()), default)

    def get(self, name: str, default=0, **labels):
        return self._counters.get((name, _label_key(labels)), default)

    def total(self, name: str):
        """Sum of a counter across all label sets."""
        return sum(v for (n, _), v in self._counters.items() if n == name)

    # -- gauges --------------------------------------------------------
    def set_gauge(self, name: str, value, **labels) -> None:
        self._gauges[(name, _label_key(labels))] = value

    def gauge(self, name: str, default=0.0, **labels):
        return self._gauges.get((name, _label_key(labels)), default)

    # -- histograms ----------------------------------------------------
    def register_histogram(self, name: str,
                           edges: Iterable[float]) -> None:
        edges = sorted(float(e) for e in edges)
        if not edges:
            raise ValueError("histogram needs at least one bucket edge")
        self._hist_edges[name] = edges

    def observe(self, name: str, value: float, **labels) -> None:
        edges = self._hist_edges.get(name)
        if edges is None:
            raise KeyError(f"histogram {name!r} not registered")
        k = (name, _label_key(labels))
        h = self._hists.get(k)
        if h is None:
            h = [[0] * (len(edges) + 1), 0.0, 0]
            self._hists[k] = h
        h[0][bisect_right(edges, value)] += 1
        h[1] += value
        h[2] += 1

    def observe_many(self, name: str, values, **labels) -> None:
        """Vectorized bulk observe (one np.histogram instead of N
        bisects — what keeps end-of-run aggregation cheap at 10^6
        outcomes)."""
        edges = self._hist_edges.get(name)
        if edges is None:
            raise KeyError(f"histogram {name!r} not registered")
        values = np.asarray(values, dtype=float)
        if values.size == 0:
            return
        k = (name, _label_key(labels))
        h = self._hists.get(k)
        if h is None:
            h = [[0] * (len(edges) + 1), 0.0, 0]
            self._hists[k] = h
        bins = np.concatenate(([-np.inf], edges, [np.inf]))
        counts, _ = np.histogram(values, bins=bins)
        for i, c in enumerate(counts):
            h[0][i] += int(c)
        h[1] += float(values.sum())
        h[2] += int(values.size)

    def histogram(self, name: str, **labels):
        """``(edges, counts, sum, n)`` for one label set, or None."""
        h = self._hists.get((name, _label_key(labels)))
        if h is None:
            return None
        return (list(self._hist_edges[name]), list(h[0]), h[1], h[2])

    # -- export --------------------------------------------------------
    @staticmethod
    def _fmt_labels(lk: tuple) -> str:
        return ",".join(f"{k}={v}" for k, v in lk)

    def as_dict(self) -> Dict[str, dict]:
        """Nested plain-dict snapshot (JSON-serializable modulo values)."""
        counters: Dict[str, dict] = {}
        for (name, lk), v in sorted(self._counters.items()):
            counters.setdefault(name, {})[self._fmt_labels(lk)] = v
        gauges: Dict[str, dict] = {}
        for (name, lk), v in sorted(self._gauges.items()):
            gauges.setdefault(name, {})[self._fmt_labels(lk)] = v
        hists: Dict[str, dict] = {}
        for (name, lk), h in sorted(self._hists.items()):
            hists.setdefault(name, {})[self._fmt_labels(lk)] = {
                "edges": list(self._hist_edges[name]),
                "counts": list(h[0]), "sum": h[1], "count": h[2],
            }
        return {"counters": counters, "gauges": gauges,
                "histograms": hists}


def counter_attr(name: str) -> property:
    """Class-level property storing a scalar counter in
    ``self.metrics`` under the unlabeled key ``name``.

    Lets a runtime replace ``self.n_rejected = 0`` instance counters
    with registry-backed ones without touching any ``+= 1`` call site.
    """
    key = (name, ())

    def fget(self):
        return self.metrics._counters.get(key, 0)

    def fset(self, value):
        self.metrics._counters[key] = value

    return property(fget, fset, doc=f"registry-backed counter {name!r}")
