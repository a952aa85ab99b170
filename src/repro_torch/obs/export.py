"""Trace exporters: Chrome/Perfetto ``trace_event`` JSON and CSV.

Perfetto layout (load the JSON at https://ui.perfetto.dev):

* one *process* per server (``pid = server index``), with tracks
  (threads) ``uplink`` (TX / KV_WAIT spans), one per compute lane
  (INFER / QUEUE spans; the lane index rides in the ``aux`` column),
  and ``events`` for instant markers;
* one process per link label used by KV migrations
  (``pid = _LINK_PID_BASE + interned label id``);
* a ``csucb`` process for bandit arm pulls;
* one flow (``ph: s``/``f``, ``id = sid``) per request from its TX span
  to its INFER span, so Perfetto draws the arrival→inference arrow even
  when the phases land on different tracks.

Timestamps are microseconds (``ts``/``dur``), per the trace_event spec.
"""
from __future__ import annotations

import csv
import json
from typing import Dict, List

from .trace import (
    KIND_ARM, KIND_INFER, KIND_KV_WAIT, KIND_MIGRATE, KIND_NAMES,
    KIND_QUEUE, KIND_TX, SPAN_KINDS, TraceRecorder,
)

_LINK_PID_BASE = 10_000
_CSUCB_PID = 20_000
_TID_UPLINK = 1
_TID_EVENTS = 0
_TID_LANE_BASE = 2


def perfetto_events(rec: TraceRecorder) -> List[dict]:
    """Build the ``traceEvents`` list from a recorder."""
    cols = rec.to_arrays()
    n = len(cols["kind"])
    events: List[dict] = []

    # metadata: name every process we are about to emit into
    servers = sorted({int(s) for s in cols["server"] if s >= 0})
    for j in servers:
        events.append({"ph": "M", "name": "process_name", "pid": j,
                       "tid": 0, "ts": 0,
                       "args": {"name": f"server {j}"}})
    mig_labels = sorted({int(a) for k, a in zip(cols["kind"], cols["aux"])
                         if k == KIND_MIGRATE and a >= 0})
    for lid in mig_labels:
        events.append({"ph": "M", "name": "process_name",
                       "pid": _LINK_PID_BASE + lid, "tid": 0, "ts": 0,
                       "args": {"name":
                                f"link {rec.label(lid) or lid}"}})
    if (cols["kind"] == KIND_ARM).any():
        events.append({"ph": "M", "name": "process_name",
                       "pid": _CSUCB_PID, "tid": 0, "ts": 0,
                       "args": {"name": "csucb bandit"}})

    span_set = set(SPAN_KINDS)
    # per-request anchors for the flow arrows
    tx_anchor: Dict[int, tuple] = {}
    infer_anchor: Dict[int, tuple] = {}

    for i in range(n):
        kind = int(cols["kind"][i])
        sid = int(cols["sid"][i])
        t0 = float(cols["t0"][i])
        t1 = float(cols["t1"][i])
        server = int(cols["server"][i])
        aux = int(cols["aux"][i])
        args = {"sid": sid, "class": int(cols["class_id"][i]),
                "tier": int(cols["tier"][i]),
                "energy_j": float(cols["energy"][i]),
                "value": float(cols["value"][i])}
        name = KIND_NAMES[kind]
        ts = t0 * 1e6
        if kind == KIND_ARM:
            events.append({"ph": "i", "s": "t", "name": "arm_pull",
                           "cat": "bandit", "pid": _CSUCB_PID,
                           "tid": _TID_LANE_BASE + server, "ts": ts,
                           "args": args})
            continue
        if kind == KIND_MIGRATE:
            pid = _LINK_PID_BASE + aux if aux >= 0 else max(server, 0)
            events.append({"ph": "X", "name": name, "cat": "kv",
                           "pid": pid, "tid": _TID_EVENTS, "ts": ts,
                           "dur": max(t1 - t0, 0.0) * 1e6,
                           "args": args})
            continue
        pid = max(server, 0)
        if kind in span_set:
            if kind in (KIND_TX, KIND_KV_WAIT):
                tid = _TID_UPLINK
            else:  # QUEUE / INFER / PREEMPT ride the compute lane
                tid = _TID_LANE_BASE + aux if aux >= 0 else _TID_LANE_BASE
            events.append({"ph": "X", "name": name, "cat": "lifecycle",
                           "pid": pid, "tid": tid, "ts": ts,
                           "dur": max(t1 - t0, 0.0) * 1e6, "args": args})
            if kind == KIND_TX and sid not in tx_anchor:
                tx_anchor[sid] = (pid, _TID_UPLINK, ts)
            elif kind == KIND_INFER:
                infer_anchor[sid] = (pid, tid, ts)
        else:
            events.append({"ph": "i", "s": "t", "name": name,
                           "cat": "lifecycle", "pid": pid,
                           "tid": _TID_EVENTS, "ts": ts, "args": args})

    for sid, (pid, tid, ts) in tx_anchor.items():
        dst = infer_anchor.get(sid)
        if dst is None:
            continue
        events.append({"ph": "s", "id": sid, "name": "req",
                       "cat": "flow", "pid": pid, "tid": tid, "ts": ts})
        events.append({"ph": "f", "bp": "e", "id": sid, "name": "req",
                       "cat": "flow", "pid": dst[0], "tid": dst[1],
                       "ts": dst[2]})
    return events


def write_perfetto(rec: TraceRecorder, path: str) -> int:
    """Write Chrome/Perfetto trace JSON; returns the event count."""
    events = perfetto_events(rec)
    with open(path, "w") as fh:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, fh)
        fh.write("\n")
    return len(events)


def validate_perfetto(path: str) -> List[str]:
    """Schema check on a written trace; returns a list of problems
    (empty == valid). Checks the keys the trace_event spec requires:
    every event has ``ph``/``pid``/``ts``, duration events have
    ``dur``."""
    problems: List[str] = []
    try:
        with open(path) as fh:
            doc = json.load(fh)
    except (OSError, json.JSONDecodeError) as e:
        return [f"unreadable trace JSON: {e}"]
    events = doc.get("traceEvents")
    if not isinstance(events, list) or not events:
        return ["traceEvents missing or empty"]
    for i, ev in enumerate(events):
        for key in ("ph", "pid", "ts"):
            if key not in ev:
                problems.append(f"event {i} missing {key!r}: {ev}")
                break
        if ev.get("ph") == "X" and "dur" not in ev:
            problems.append(f"complete event {i} missing 'dur'")
        if len(problems) >= 10:
            problems.append("... (truncated)")
            break
    return problems


def write_csv(rec: TraceRecorder, path: str) -> int:
    """Columnar CSV dump (one row per trace row); returns row count."""
    cols = rec.to_arrays()
    n = len(cols["kind"])
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["kind", "sid", "t0", "t1", "server", "class_id",
                    "tier", "energy", "value", "aux", "aux_label"])
        for i in range(n):
            aux = int(cols["aux"][i])
            w.writerow([
                KIND_NAMES[int(cols["kind"][i])], int(cols["sid"][i]),
                repr(float(cols["t0"][i])), repr(float(cols["t1"][i])),
                int(cols["server"][i]), int(cols["class_id"][i]),
                int(cols["tier"][i]), repr(float(cols["energy"][i])),
                repr(float(cols["value"][i])), aux,
                rec.label(aux) or "",
            ])
    return n
