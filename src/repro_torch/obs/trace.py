"""Columnar, ring-buffered request-lifecycle trace recorder.

The recorder is the substrate for per-request timelines (docs/
observability.md): every lifecycle phase — arrival, scheduling decision,
uplink transmission, KV-admission wait, inference, completion — plus the
non-happy-path events (reject, preempt, migrate, resume) and CSUCB arm
pulls land here as fixed-width rows in preallocated numpy columns.

Design constraints (the "overhead contract"):

* **Nothing expensive on the hot path.** Writers push plain tuples
  onto ``deque(maxlen=...)`` staging — no numpy element conversion
  while the traced system runs. The dominant writer, one completion
  per request, uses :meth:`complete`: a single 13-scalar record (one
  tuple, one deque append) that materialization expands into the four
  TX/QUEUE/INFER/DONE schema rows vectorized. The PyObject→column
  conversion (the genuinely costly part, ~60 ns per stored scalar)
  happens exactly once, lazily, the first time a reader asks for
  :meth:`to_arrays` — off the window the CI traced-overhead gate times.
  Instrumenting the array event core therefore costs ~1 µs per arrival
  against its ~30 µs baseline, which is what keeps the gate under 10%.
* **No side effects on the traced system.** The recorder never draws
  RNG, never reads lazily-materialized views, and never mutates ledger
  state; traced runs are result-bit-identical to untraced runs (golden
  tested in ``tests/test_obs.py``).
* **Bounded memory.** Staging is two bounded tables — generic rows
  (at most ``capacity``) and completion records (at most
  ``capacity // 4`` records of four rows each) — so the surviving
  window never exceeds ~2·``capacity`` rows. Once a table fills, its
  oldest entries fall off the front and ``dropped`` counts what was
  lost. Readers receive the surviving window as numpy columns sorted
  by ``(t0, kind)`` — a deterministic chronological order shared by
  both sim cores.

Row schema (one value per column; unused fields hold the defaults):

========  =======  ====================================================
column    dtype    meaning
========  =======  ====================================================
kind      int8     one of the ``KIND_*`` constants below
sid       int64    service id (``ARM`` rows: the bandit's pull count)
t0        float64  span start (seconds, sim clock)
t1        float64  span end; ``t0 == t1`` for instant markers
server    int32    server index (``MIGRATE``: destination), -1 n/a
class_id  int16    request class, -1 n/a
tier      int16    DVFS tier of the granted allocation, 0 nominal
energy    float64  energy attributed to the span (J); ``ARM``: reward
value     float64  kind-specific payload (see ``KIND_VALUE_DOC``)
aux       int32    interned label id (links/lanes), -1 n/a
========  =======  ====================================================
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional

import numpy as np

# lifecycle kinds ------------------------------------------------------
KIND_ARRIVAL = 0    # re-entry marker (requeue after preempt); a first
#                     arrival is implicit as its TX span's t0
KIND_DECISION = 1   # placement marker for sheds and re-placements;
#                     value = 1.0 admit / 0.0 shed. Happy-path decisions
#                     are implicit (server/tier ride on the TX/INFER
#                     spans, decision time == arrival)
KIND_TX = 2         # arrival -> uplink transfer complete ("ready")
KIND_QUEUE = 3      # ready -> inference begin (lane wait)
KIND_KV_WAIT = 4    # blocked in the KV admission queue (nested in TX)
KIND_INFER = 5      # inference begin -> finish; value = output tokens
KIND_DONE = 6       # completion marker; value = 1.0 SLO met / 0.0 missed
KIND_REJECT = 7     # admission control shed the request
KIND_PREEMPT = 8    # lane reclaimed; span covers the wasted decode
KIND_MIGRATE = 9    # cross-server KV page transfer; value = bytes
KIND_RESUME = 10    # dispatch resumed preserved KV pages (no re-prefill)
KIND_ARM = 11       # CSUCB arm pull; energy = reward, value = violation

KIND_NAMES = (
    "ARRIVAL", "DECISION", "TX", "QUEUE", "KV_WAIT", "INFER", "DONE",
    "REJECT", "PREEMPT", "MIGRATE", "RESUME", "ARM",
)

#: kinds rendered as duration slices (everything else is a marker)
SPAN_KINDS = (KIND_TX, KIND_QUEUE, KIND_KV_WAIT, KIND_INFER,
              KIND_PREEMPT, KIND_MIGRATE)

KIND_VALUE_DOC = {
    KIND_DECISION: "1.0 admitted / 0.0 shed",
    KIND_INFER: "output tokens decoded",
    KIND_DONE: "1.0 deadline met / 0.0 missed",
    KIND_MIGRATE: "KV bytes shipped",
    KIND_ARM: "violation severity fed to CSUCB",
}

_COLUMNS = (
    ("kind", np.int8), ("sid", np.int64), ("t0", np.float64),
    ("t1", np.float64), ("server", np.int32), ("class_id", np.int16),
    ("tier", np.int16), ("energy", np.float64), ("value", np.float64),
    ("aux", np.int32),
)


def _expand_completions(d: np.ndarray) -> np.ndarray:
    """Expand (m, 13) completion records into the (4m, 10) schema rows
    TX / QUEUE / INFER / DONE — all slice assignments, no Python loop
    over records."""
    m = d.shape[0]
    sid, arrival, ready, begin, finish = (d[:, i] for i in range(5))
    server, cls, tier, lane = (d[:, i] for i in range(5, 9))
    e_tx, e_inf, tokens, success = (d[:, i] for i in range(9, 13))
    out = np.empty((4 * m, 10), dtype=np.float64)
    rows = (
        (KIND_TX, arrival, ready, e_tx, 0.0, -1.0),
        (KIND_QUEUE, ready, begin, 0.0, 0.0, lane),
        (KIND_INFER, begin, finish, e_inf, tokens, lane),
        (KIND_DONE, finish, finish, 0.0, success, -1.0),
    )
    for off, (kind, t0, t1, energy, value, aux) in enumerate(rows):
        blk = out[off::4]
        blk[:, 0] = kind
        blk[:, 1] = sid
        blk[:, 2] = t0
        blk[:, 3] = t1
        blk[:, 4] = server
        blk[:, 5] = cls
        blk[:, 6] = tier
        blk[:, 7] = energy
        blk[:, 8] = value
        blk[:, 9] = aux
    return out


class TraceRecorder:
    """Ring-buffered columnar store for lifecycle rows.

    Pass one instance as ``trace=`` to ``Simulator.run`` /
    ``PerLLMServer`` (and optionally attach it to ``CSUCB.trace``); read
    it back with :meth:`to_arrays` or the exporters in
    :mod:`repro_torch.obs.export`.
    """

    def __init__(self, capacity: int = 1 << 18) -> None:
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = int(capacity)
        self.n_total = 0
        self._buf: deque = deque(maxlen=self.capacity)
        self._done: deque = deque(maxlen=max(1, self.capacity // 4))
        self._labels: List[str] = []
        self._label_ids: Dict[str, int] = {}
        self._mat: Optional[Dict[str, np.ndarray]] = None
        self._mat_stamp = -1

    # -- write path ----------------------------------------------------
    def append(self, kind: int, sid: int, t0: float, t1: float,
               server: int = -1, class_id: int = -1, tier: int = 0,
               energy: float = 0.0, value: float = 0.0,
               aux: int = -1) -> None:
        """Record one row. Hot path: one tuple + one deque append."""
        self._buf.append((kind, sid, t0, t1, server, class_id, tier,
                          energy, value, aux))
        self.n_total += 1

    def append_rows(self, rows) -> None:
        """Batch append of pre-built 10-tuples (one call per lifecycle
        batch keeps the instrumented runtimes' per-arrival cost down)."""
        self._buf.extend(rows)
        self.n_total += len(rows)

    def complete(self, sid: int, arrival: float, ready: float,
                 begin: float, finish: float, server: int = -1,
                 class_id: int = -1, tier: int = 0, lane: int = -1,
                 e_tx: float = 0.0, e_inf: float = 0.0, tokens: int = 0,
                 success=False) -> None:
        """Record one completed request's whole TX/QUEUE/INFER/DONE
        lifecycle as a single 13-scalar record — the hottest write in
        every traced run (one per served request). Materialization
        expands it into the four schema rows, so readers never see the
        compressed form."""
        self._done.append((sid, arrival, ready, begin, finish, server,
                           class_id, tier, lane, e_tx, e_inf, tokens,
                           success))
        self.n_total += 4

    def intern(self, label: str) -> int:
        """Map a string label (link name, lane id) to a stable int for
        the ``aux`` column."""
        lid = self._label_ids.get(label)
        if lid is None:
            lid = len(self._labels)
            self._label_ids[label] = lid
            self._labels.append(label)
        return lid

    def flush(self) -> None:
        """Materialize the columnar view now (optional — readers do this
        lazily). Kept so callers can pay the conversion cost at a chosen
        point, e.g. after a timed region, instead of at first read."""
        self._materialize()

    def _materialize(self) -> Dict[str, np.ndarray]:
        """Convert the staging deques into numpy columns, cached until
        the next write. This is the only PyObject→array conversion and
        it never runs on the recording hot path. Rows come out sorted
        by ``(t0, kind)`` — deterministic regardless of which staging
        table a row lived in."""
        if self._mat is not None and self._mat_stamp == self.n_total:
            return self._mat
        parts = []
        if self._buf:
            parts.append(np.array(self._buf, dtype=np.float64))
        if self._done:
            parts.append(_expand_completions(
                np.array(self._done, dtype=np.float64)))
        if parts:
            raw = parts[0] if len(parts) == 1 else np.concatenate(parts)
            raw = raw[np.lexsort((raw[:, 0], raw[:, 2]))]
            self._mat = {name: raw[:, i].astype(dt, copy=False)
                         for i, (name, dt) in enumerate(_COLUMNS)}
        else:
            self._mat = {name: np.zeros(0, dtype=dt)
                         for name, dt in _COLUMNS}
        self._mat_stamp = self.n_total
        return self._mat

    # -- read path -----------------------------------------------------
    def __len__(self) -> int:
        return len(self._buf) + 4 * len(self._done)

    @property
    def dropped(self) -> int:
        """Rows that fell off the front of the ring (0 unless capacity
        was exceeded)."""
        return self.n_total - len(self)

    @property
    def labels(self) -> List[str]:
        return list(self._labels)

    def label(self, aux: int) -> Optional[str]:
        if 0 <= aux < len(self._labels):
            return self._labels[aux]
        return None

    def to_arrays(self) -> Dict[str, np.ndarray]:
        """Chronological copy of the surviving window, column-major."""
        return {name: col.copy()
                for name, col in self._materialize().items()}

    def timeline(self, sid: int) -> Dict[str, np.ndarray]:
        """All rows for one request, chronological."""
        cols = self._materialize()
        mask = (cols["sid"] == sid) & (cols["kind"] != KIND_ARM)
        return {name: col[mask] for name, col in cols.items()}
