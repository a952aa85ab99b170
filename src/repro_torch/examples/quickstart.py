"""Quickstart: train a tiny model, serve it with continuous batching, and
schedule requests onto a DVFS-tiered edge-cloud testbed.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The four steps of the JAX package's `examples/quickstart.py`, on the card
unless ``--device`` names another: reduced gemma-2b is trained 30 steps on
the synthetic bigram stream (the flash kernel in every forward), serves 6
requests greedily (flash at prefill, the decode kernel at every step), and
the simulator schedules a workload on the paper's testbed with and without
learned frequency tiers.
"""
from __future__ import annotations

import argparse
import copy

from repro_torch.cluster import (
    DVFS_TIERS, Simulator, generate_workload, paper_testbed,
)
from repro_torch.configs import get_config
from repro_torch.core import make_policy
from repro_torch.models import resolve_device
from repro_torch.serving import ServingEngine
from repro_torch.training import AdamWConfig, train


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda or cpu)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # 1. pick an architecture from the zoo and shrink it
    cfg = get_config("gemma-2b").reduced(n_layers=2, d_model=128,
                                         vocab_size=512)
    print(f"arch={cfg.arch_id} params={cfg.param_count()/1e6:.1f}M")

    # 2. train briefly on the synthetic bigram stream
    params, _, hist = train(
        cfg, steps=30, batch_size=4, seq_len=64, log_every=10,
        opt_cfg=AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=30),
        device=device)
    print(f"loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")

    # 3. serve it
    engine = ServingEngine(cfg, params, max_batch=4, max_seq=128,
                           temperature=0.0, device=device)
    reqs = [engine.submit(list(range(10 + i, 18 + i)), max_new_tokens=8)
            for i in range(6)]
    engine.run_until_idle()
    for r in reqs[:3]:
        print(f"req {r.rid}: prompt={r.prompt[:4]}... -> {r.generated}")

    # 4. schedule a workload: every Decision names a server AND a resource
    #    Allocation — here PerLLM learns which DVFS tier each service class
    #    can afford (a slow tier that still meets the deadline is cheaper)
    specs = paper_testbed("llama2-7b", freq_tiers=DVFS_TIERS)
    services = generate_workload(800, rate=8.0, seed=0)
    rows = []
    for tiers, tag in ((False, "fixed-nominal"), (True, "learned-tiers")):
        sim = Simulator(specs, slot=None, seed=42)
        res = sim.run([copy.copy(s) for s in services],
                      make_policy("perllm", len(specs), tiers=tiers))
        rows.append(f"{tag:14s} {res.row()}")
        print(rows[-1])
    return {"history": hist, "requests": reqs, "engine": engine,
            "schedule": rows}


if __name__ == "__main__":
    main()
