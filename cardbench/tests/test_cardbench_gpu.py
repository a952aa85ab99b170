"""On the card (``-m gpu``): each cell at its own size on three seeds,
short windows at its own load: every run correct, and the fp8 control,
put in the program's place on the same sample, over the cell's limit."""
import gc
import time

import pytest

from cardbench.core import cell as C
from cardbench.core import registry

CELLS = [w["name"] for w in registry.load_json(
    registry.BENCH_DIR.parent / "BENCHMARK.json")["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_cell_at_its_size(name, card):
    import torch
    c = registry.cell(name)
    for seed in (7, 2**31 + 9, 3 * 10**9 + 1):
        prep = C.Prepared(c, seed, card, time.perf_counter())
        out = C.measure(c, prep, seed=seed, seconds=10.0, trace=False,
                        device=card, control=True)
        assert out["correct"], (seed, out["checks"])
        _, ctrl = prep.gaps
        lim = c.settings["limits"]
        assert any(v > lim[k] for k, v in (("max_logit_gap", ctrl.max()),
                                           ("mean_logit_gap", ctrl.mean()))
                   if k in lim), seed
        del prep
        gc.collect()
        torch.cuda.empty_cache()
