"""The paper's scenario end-to-end: PerLLM scheduling over real engines.

Edge servers run a small model, the cloud runs a larger one (both reduced).
Service requests flow through the CS-UCB scheduler; chosen servers execute
real prefill/decode through the port's continuous-batching engine (the
flash and decode kernels on the card, their plain versions on the CPU),
and the cluster simulator accounts time and energy. Compares PerLLM
against FineInfer, and the allocation-aware contract: the testbed carries
a DVFS frequency ladder, so each `Decision` names a (server, tier) pair
and the learned-tier policy undercuts the fixed-nominal one on energy.

    PYTHONPATH=src python -m repro_torch.examples.perllm_serving [--device cpu]

It runs on the card unless ``--device`` names another; ``--services`` and
``--requests`` size the simulated workload and the slice of it that runs
on the engines (the defaults are the JAX package's example's).
"""
from __future__ import annotations

import argparse
import copy

from repro_torch.cluster import (
    BandwidthModel, DVFS_TIERS, Simulator, generate_workload, paper_testbed,
)
from repro_torch.cluster.workload import classify
from repro_torch.configs import get_config
from repro_torch.core import ClusterView, drive_slot, make_policy
from repro_torch.models import init_params, resolve_device
from repro_torch.serving import ServingEngine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device to run the engines on (cuda or cpu)")
    ap.add_argument("--services", type=int, default=600,
                    help="services in the simulated workload")
    ap.add_argument("--requests", type=int, default=24,
                    help="services of the workload run on the engines")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # --- real execution engines (reduced models) ------------------------
    edge_cfg = get_config("gemma-2b").reduced(n_layers=2, d_model=64,
                                              vocab_size=256)
    cloud_cfg = get_config("gemma3-12b").reduced(n_layers=2, d_model=128,
                                                 vocab_size=256)
    # every server carries the stock DVFS ladder: scheduling decisions are
    # (server, tier) pairs, not bare placements
    specs = paper_testbed("llama2-7b", n_edge=2, freq_tiers=DVFS_TIERS)
    engines = [ServingEngine(edge_cfg, init_params(edge_cfg, device=device),
                             max_batch=2, max_seq=64, device=device)
               for _ in range(2)]
    engines.append(ServingEngine(cloud_cfg,
                                 init_params(cloud_cfg, device=device),
                                 max_batch=4, max_seq=64, device=device))

    services = generate_workload(args.services, rate=8.0, seed=0)
    lines = []

    def say(line: str) -> None:
        print(line, flush=True)
        lines.append(line)

    for name in ("perllm", "fineinfer"):
        sim = Simulator(specs, BandwidthModel(False, seed=1), seed=42)
        res = sim.run([copy.copy(s) for s in services],
                      make_policy(name, len(specs)))
        say(res.row())

    # --- the energy story: learned tier selection vs the nominal clock --
    for tiers, tag in ((False, "fixed-nominal"), (True, "learned-tiers")):
        sim = Simulator(specs, BandwidthModel(False, seed=1), slot=None,
                        seed=42)
        res = sim.run([copy.copy(s) for s in services],
                      make_policy("perllm", len(specs), admission=True,
                                  tiers=tiers))
        say(f"{tag:14s} energy={res.total_energy/1e3:6.1f} kJ "
            f"({res.energy_per_token:.2f} J/tok) "
            f"adm_succ={res.admitted_success_rate*100:5.1f}%")

    # --- the same cluster, event-driven: per-arrival views, feedback at
    # true completion time, plus a bursty workload with a mid-run cloud
    # bandwidth drop (Scenario hooks on the shared event loop) -----------
    bursty = generate_workload(args.services, rate=8.0, seed=0,
                               scenario="burst")
    sim = Simulator(specs, BandwidthModel(False, seed=1), slot=None, seed=42)
    res = sim.run([copy.copy(s) for s in bursty],
                  make_policy("perllm", len(specs)), scenario="bwdrop")
    say(f"event-driven burst+bwdrop: {res.row()}")

    # --- drive a slice of real tokens through the chosen engines --------
    # Each Decision's Allocation says how the engine's host is paced: the
    # chosen DVFS tier is printed alongside the placement.
    policy = make_policy("perllm", len(specs))
    view = ClusterView(t=0.0, specs=specs, bw_factor=[1.0] * len(specs),
                       uplink_free_at=[0.0] * len(specs),
                       lane_free=[[0.0] * s.max_concurrency for s in specs])
    slice_ = services[:args.requests]
    for s in slice_:
        s.class_id = classify(s)
    decisions = drive_slot(policy, slice_, view, 0)
    tiers_chosen = [specs[d.server].tier_freq(d.alloc.freq_tier)
                    for d in decisions]
    say("allocations: " + " ".join(
        f"s{d.server}@f{f:.2f}"
        for d, f in zip(decisions[:8], tiers_chosen[:8],
                        strict=True)) + " ...")
    for svc, d in zip(slice_, decisions, strict=True):
        engines[d.server].set_freq_scale(
            specs[d.server].tier_freq(d.alloc.freq_tier))
        engines[d.server].submit([1 + svc.sid % 40, 2, 3, 4],
                                 max_new_tokens=4)
    done = sum(len(e.run_until_idle()) for e in engines)
    per_engine = [len(e.completed) for e in engines]
    say(f"executed {done}/{len(slice_)} requests on real engines "
        f"(edge0={per_engine[0]}, edge1={per_engine[1]}, "
        f"cloud={per_engine[2]}) on {device}")
    return {"lines": lines, "done": done, "requests": len(slice_),
            "per_engine": per_engine, "engines": engines}


if __name__ == "__main__":
    main()
