"""Find an open-loop cell's knee on the card: the cell's traffic at each of
several offered rates on one set of weights, one window each.

    python3 cardbench/tools/sweep.py --workload <name> --seconds <s> \
        --rates <r> <r> ... [--seed <n>] [--out <file.jsonl>]

One JSON line a rate: offered and completed requests a second in the
window, output tokens a second, time to first token (median and 95th
percentile, and the median over the window's first and last thirds: a
growing queue shows as a rise), the deadline-met share and how many
requests due in the window were still unfinished at the end.
"""
import argparse
import gc
import json
import math
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from cardbench.core import cell as C
    from cardbench.core import port, registry
    if not torch.cuda.is_available():
        print("sweep: no CUDA card", file=sys.stderr)
        return 2
    cell = registry.cell(args.workload)
    prep = C.Prepared(cell, args.seed, "cuda", time.perf_counter())
    for rate in args.rates:
        if prep.engine is None:
            prep.engine = port.engine(cell.config, prep.weights, "cuda")
        out = C.measure(cell, prep, seed=args.seed, seconds=args.seconds,
                        trace=False, device="cuda", rate=rate, judge=False)
        rec = prep.record
        t0, t1 = rec.window
        due = rec.due_in_window()
        ttft = [((r.stamps[0] if r.stamps else rec.end) - r.due) * 1e3
                for r in due]
        third = (t1 - t0) / 3
        early = [x for r, x in zip(due, ttft, strict=True)
                 if r.due < t0 + third]
        late = [x for r, x in zip(due, ttft, strict=True)
                if r.due >= t1 - third]
        row = {"workload": args.workload, "rate": rate,
               "offered_per_s": len(due) / rec.window_s,
               "completed_per_s": sum(1 for r in rec.requests
                                      if rec.in_window(r.done))
               / rec.window_s,
               "unfinished": sum(1 for r in due if math.isnan(r.done)),
               "ttft_p50_ms": statistics.median(ttft) if ttft else None,
               "ttft_p50_first_third_ms": statistics.median(early)
               if early else None,
               "ttft_p50_last_third_ms": statistics.median(late)
               if late else None,
               "metrics": {k: v["value"] for k, v in out["metrics"].items()}}
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        prep.record = None
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
