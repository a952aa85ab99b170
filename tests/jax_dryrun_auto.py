"""The JAX package's dry run of (arch, shape) pairs on the production mesh,
with the mesh's axes made Auto, one JSON report a line.

Usage: PYTHONPATH=src python tests/jax_dryrun_auto.py gemma-2b:prefill_32k
[ARCH:SHAPE ...]

`jax.make_mesh` makes Explicit axes in this JAX, and the JAX package's
``with_sharding_constraint`` refuses those, so its own dry run raises (as
``tests/test_distribution.py``'s three tests do). Here
`repro.launch.dryrun.make_production_mesh` is replaced in memory by one
that builds Auto axes; no file of the JAX package changes. Importing
`repro.launch.dryrun` sets XLA_FLAGS to 512 host devices before JAX starts,
so this runs in a process of its own. It holds no tests.
"""
import json
import sys

import repro.launch.dryrun as D  # noqa: I001  (sets XLA_FLAGS first)
import jax
from jax.sharding import AxisType


def auto_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes))


if __name__ == "__main__":
    D.make_production_mesh = auto_mesh
    for pair in sys.argv[1:]:
        arch, shape = pair.split(":")
        print(json.dumps(D.run_one(arch, shape, verbose=False), default=float),
              flush=True)
