"""Readings to set a cell's correctness limit from, on the card.

    python3 cardbench/tools/calibrate.py --workload <name> --seconds <s> \
        --seeds <n> <n> ... [--out <file.jsonl>]

For each seed, in one process: the cell's set-up, a short window of its own
traffic at its own load, the sample a run compares, the program's widest
logit gap (`max_logit_gap`) and the fp8 control's on the same sample. One
JSON line a seed to standard output (and to `--out`).
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[2]


def _summary(g) -> dict:
    """Other numbers of one gap array (per served token)."""
    import numpy as np
    return {"mean": float(g.mean()), "p90": float(np.percentile(g, 90)),
            "p99": float(np.percentile(g, 99)),
            "nonzero_share": float((g > 1e-6).mean()),
            "over_0.1_share": float((g > 0.1).mean()), "n": int(g.size)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from cardbench.core import cell as C
    from cardbench.core import registry
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = registry.cell(args.workload)
    for seed in args.seeds:
        t = time.perf_counter()
        prep = C.Prepared(cell, seed, "cuda", t)
        out = C.measure(cell, prep, seed=seed, seconds=args.seconds,
                        trace=False, device="cuda", control=True)
        g, cg = prep.gaps
        row = {"workload": args.workload, "seed": seed,
               "gaps": _summary(g), "control_gaps": _summary(cg),
               "gap": out["info"]["gaps"]["max_logit_gap"],
               "control_gap": out["info"]["control_gaps"]["max_logit_gap"],
               "correct": out["correct"],
               "compared": out["checks"]["compared_tokens"]["value"],
               "checks": out["checks"],
               "metrics": {k: v["value"] for k, v in out["metrics"].items()},
               "peak_gib": out["device"]["memory_peak_bytes"] / 2**30,
               "seconds": time.perf_counter() - t}
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        del prep
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
