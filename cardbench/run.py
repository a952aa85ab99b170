"""The benchmark of the port (``repro_torch``) on one card.

    python3 cardbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

runs the cell `<name>` of ``BENCHMARK.json`` once: set-up, the traffic,
`<s>` seconds of measured window, the check against the plain reference.
Its last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, then ``info`` and ``checks``, each number compared beside
its limit. The same numbers are the last lines of standard error. Without
a card, or with fewer cards than the cell asks for, it exits 2 and prints
no result.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache at a fixed path inside the checkout (the
# port builds its CUDA library under src/repro_torch/kernels/build/)
CACHE = ROOT / ".cardbench_cache"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch

    from cardbench.core import registry
    cell = registry.cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"cardbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (the system under test must be here)
    torch.set_num_threads(2)

    from cardbench.core import cell as run_cell
    out = run_cell.run(cell, seed=args.seed, seconds=args.seconds,
                       trace=bool(args.trace), device="cuda",
                       t_process=T_PROCESS)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
