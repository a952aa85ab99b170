"""The JAX package's dry run of (arch, shape) pairs on the production mesh,
with the mesh's axes made Auto, one JSON report a line.

Usage: PYTHONPATH=src python tests/jax_dryrun_auto.py gemma-2b:prefill_32k
[ARCH:SHAPE ...]
       PYTHONPATH=src python tests/jax_dryrun_auto.py --scan [ARCH ...]

`jax.make_mesh` makes Explicit axes in this JAX, and the JAX package's
``with_sharding_constraint`` refuses those, so its own dry run raises (as
``tests/test_distribution.py``'s three tests do). Here
`repro.launch.dryrun.make_production_mesh` is replaced in memory by one
that builds Auto axes; no file of the JAX package changes. Importing
`repro.launch.dryrun` sets XLA_FLAGS to 512 host devices before JAX starts,
so this runs in a process of its own. It holds no tests.

``--scan`` shows how that dry run counts the collectives of a scanned
layer stack: for each arch (gemma-2b by default), the reduced float32
config's train step (B 8 x S 64) at 2 and at 4 layers on a (2, 4) Auto
mesh, with `repro.launch.dryrun.collective_bytes` of its optimized HLO
text. Equal bytes at both depths mean the loop body's collectives are
counted once, however many layers the loop runs.
"""
import dataclasses
import json
import sys

import repro.launch.dryrun as D  # noqa: I001  (sets XLA_FLAGS first)
import jax
from jax.sharding import AxisType

from repro.configs import InputShape, get_config


def auto_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes))


def scan_bytes(arch: str, n_layers: int) -> dict:
    cfg = dataclasses.replace(get_config(arch).reduced(n_layers=n_layers),
                              dtype="float32")
    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    fn, args = D.build(cfg, InputShape("train_64", 64, 8, "train"),
                       D.make_context(mesh))
    hlo = fn.lower(*args).compile().as_text()
    return {"arch": arch, "n_layers": n_layers,
            "collective_bytes": D.collective_bytes(hlo)}


if __name__ == "__main__":
    if sys.argv[1:2] == ["--scan"]:
        for arch in sys.argv[2:] or ["gemma-2b"]:
            for n in (2, 4):
                print(json.dumps(scan_bytes(arch, n)), flush=True)
        sys.exit(0)
    D.make_production_mesh = auto_mesh
    for pair in sys.argv[1:]:
        arch, shape = pair.split(":")
        print(json.dumps(D.run_one(arch, shape, verbose=False), default=float),
              flush=True)
