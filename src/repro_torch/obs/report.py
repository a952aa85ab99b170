"""SLO-attribution report CLI.

Runs a seeded benchmark workload with tracing enabled and prints where
the time went — per-phase (tx / queue / kv-wait / infer) breakdowns for
all completions, for the p95 latency tail, and for SLO violations —
plus the CSUCB arm-pull / violation timeline from the bandit. Optionally
exports the trace as Perfetto JSON and/or CSV.

Usage::

    PYTHONPATH=src python -m repro_torch.obs.report --n 2000 --seed 0 \
        --perfetto trace.json --check

``--check`` re-reads the written Perfetto JSON and validates the
required ``ph``/``ts``/``pid`` keys, exiting non-zero on failure (the CI
smoke step).
"""
from __future__ import annotations

import argparse
import sys
import tempfile
from collections import defaultdict

import numpy as np

from repro_torch.cluster import (
    BandwidthModel, Simulator, generate_workload, paper_testbed,
)
from repro_torch.core import make_policy

from .export import validate_perfetto, write_csv, write_perfetto
from .trace import (
    KIND_ARM, KIND_DONE, KIND_INFER, KIND_KV_WAIT, KIND_NAMES,
    KIND_QUEUE, KIND_REJECT, KIND_TX, TraceRecorder,
)

_PHASES = ((KIND_TX, "tx"), (KIND_QUEUE, "queue"),
           (KIND_KV_WAIT, "kv_wait"), (KIND_INFER, "infer"))


def run_traced(n: int, rate: float, seed: int, n_edge: int,
               policy_name: str, scenario, capacity: int):
    """One seeded simulator run with the recorder attached to both the
    runtime and (when the policy has one) the CSUCB bandit."""
    specs = paper_testbed(n_edge=n_edge)
    services = generate_workload(n, rate=rate, seed=seed)
    rec = TraceRecorder(capacity=capacity)
    policy = make_policy(policy_name, len(specs))
    bandit = getattr(policy, "bandit", None)
    if bandit is not None:
        bandit.trace = rec
    sim = Simulator(specs, BandwidthModel(fluctuating=False), seed=seed)
    res = sim.run(services, policy, scenario=scenario, trace=rec)
    return rec, res


def _per_request(cols):
    """sid -> {phase: duration}, plus DONE/slo flags."""
    phases = defaultdict(lambda: defaultdict(float))
    done = {}
    for i in range(len(cols["kind"])):
        kind = int(cols["kind"][i])
        sid = int(cols["sid"][i])
        if kind == KIND_DONE:
            done[sid] = bool(cols["value"][i])
            continue
        for pk, pname in _PHASES:
            if kind == pk:
                phases[sid][pname] += float(cols["t1"][i]
                                            - cols["t0"][i])
                break
    return phases, done


def _phase_table(title, sids, phases, out):
    names = [p for _, p in _PHASES]
    if not sids:
        out.append(f"{title}: (none)")
        return
    sums = {p: sum(phases[s].get(p, 0.0) for s in sids) for p in names}
    # kv_wait nests inside tx: exclude it from the share denominator
    total = sum(v for p, v in sums.items() if p != "kv_wait")
    out.append(f"{title} ({len(sids)} requests):")
    for p in names:
        mean = sums[p] / len(sids)
        share = (100.0 * sums[p] / total) if total > 0 else 0.0
        nested = "  (within tx)" if p == "kv_wait" else ""
        out.append(f"    {p:8s} mean {mean * 1e3:9.2f} ms"
                   f"  share {share:5.1f}%{nested}")


def _arm_report(cols, out, bins=8):
    mask = cols["kind"] == KIND_ARM
    if not mask.any():
        out.append("CSUCB arm pulls: (no bandit trace attached)")
        return
    t = cols["t0"][mask]
    srv = cols["server"][mask]
    cls = cols["class_id"][mask]
    viol = cols["value"][mask]
    pulls = defaultdict(int)
    viols = defaultdict(float)
    for c, j, v in zip(cls, srv, viol):
        pulls[(int(c), int(j))] += 1
        viols[(int(c), int(j))] += float(v)
    out.append(f"CSUCB arm pulls: {int(mask.sum())} updates, "
               f"{len(pulls)} distinct (class, server) arms")
    top = sorted(pulls, key=lambda k: -pulls[k])[:10]
    out.append("    arm (class, server)    pulls   sum(violation)")
    for key in top:
        out.append(f"    {str(key):20s} {pulls[key]:6d}   "
                   f"{viols[key]:10.3f}")
    lo, hi = float(t.min()), float(t.max())
    span = max(hi - lo, 1e-9)
    edges = lo + span * np.arange(bins + 1) / bins
    out.append(f"  timeline ({bins} bins over "
               f"[{lo:.1f}s, {hi:.1f}s]):")
    idx = np.minimum((bins * (t - lo) / span).astype(int), bins - 1)
    pull_bins = np.bincount(idx, minlength=bins)
    viol_bins = np.bincount(idx, weights=(viol > 0), minlength=bins)
    out.append("    pulls      " + " ".join(f"{int(v):6d}"
                                            for v in pull_bins))
    out.append("    violations " + " ".join(f"{int(v):6d}"
                                            for v in viol_bins))
    _ = edges  # edges shown implicitly via the range line


def render_report(rec: TraceRecorder, res) -> str:
    cols = rec.to_arrays()
    out = []
    n_rows = len(cols["kind"])
    out.append(f"trace: {n_rows} rows ({rec.dropped} dropped), kinds: "
               + ", ".join(
                   f"{KIND_NAMES[k]}={int((cols['kind'] == k).sum())}"
                   for k in sorted(set(int(x) for x in cols["kind"]))))
    out.append(f"run: success_rate={res.success_rate:.4f} "
               f"avg={res.avg_processing_time:.3f}s "
               f"p95={res.p95_processing_time:.3f}s "
               f"rejected={res.n_rejected} preempted={res.n_preempted} "
               f"energy/token={res.energy_per_token:.4f}")

    phases, done = _per_request(cols)
    completed = sorted(done)
    _phase_table("phase breakdown, all completions", completed, phases,
                 out)

    totals = {s: sum(v for p, v in phases[s].items() if p != "kv_wait")
              for s in completed}
    if completed:
        p95 = float(np.percentile(list(totals.values()), 95))
        tail = [s for s in completed if totals[s] >= p95]
        _phase_table(f"p95 tail (>= {p95 * 1e3:.1f} ms)", tail, phases,
                     out)
    missed = [s for s in completed if not done[s]]
    _phase_table("SLO violations (completed, deadline missed)", missed,
                 phases, out)
    n_rej = int((cols["kind"] == KIND_REJECT).sum())
    out.append(f"shed by admission control: {n_rej}")

    _arm_report(cols, out)
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Traced benchmark run + SLO-violation attribution "
                    "report (and Perfetto/CSV export).")
    ap.add_argument("--n", type=int, default=2000,
                    help="workload size (default 2000)")
    ap.add_argument("--rate", type=float, default=50.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-edge", type=int, default=4)
    ap.add_argument("--policy", default="perllm")
    ap.add_argument("--scenario", default=None)
    ap.add_argument("--capacity", type=int, default=1 << 18,
                    help="recorder ring capacity in rows")
    ap.add_argument("--perfetto", metavar="PATH", default=None,
                    help="write Chrome/Perfetto trace JSON")
    ap.add_argument("--csv", metavar="PATH", default=None,
                    help="write columnar CSV dump")
    ap.add_argument("--check", action="store_true",
                    help="validate the written Perfetto JSON schema "
                         "(writes a temp file if --perfetto not given)")
    args = ap.parse_args(argv)

    rec, res = run_traced(args.n, args.rate, args.seed, args.n_edge,
                          args.policy, args.scenario, args.capacity)
    print(render_report(rec, res))

    if args.csv:
        n = write_csv(rec, args.csv)
        print(f"wrote {args.csv} ({n} rows)")
    path = args.perfetto
    if args.check and path is None:
        path = tempfile.mktemp(suffix=".json", prefix="repro_trace_")
    if path:
        n = write_perfetto(rec, path)
        print(f"wrote {path} ({n} trace events)")
    if args.check:
        problems = validate_perfetto(path)
        if problems:
            for p in problems:
                print(f"perfetto schema: {p}", file=sys.stderr)
            return 1
        print("perfetto schema: valid")
    return 0


if __name__ == "__main__":
    sys.exit(main())
