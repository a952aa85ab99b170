"""Production meshes.

Functions, never module-level constants, so that importing this module
touches no process group. ``make_production_mesh`` lays the JAX package's
production shapes, 256 ranks as (16, 16) ``("data", "model")`` or 512 as
(2, 16, 16) ``("pod", "data", "model")``, over whatever process group the
caller set up: the dry run's is a fake one (``launch/dryrun.py``), in which
this process is rank 0 and no collective moves data.
"""
from __future__ import annotations

from repro_torch.models.parallel import Mesh, init_mesh


def production_shape(multi_pod: bool = False):
    """(shape, axis names) of the 256- or 512-rank production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False,
                         backend: str = "fake") -> Mesh:
    """The 256-rank (16, 16) mesh; ``multi_pod`` adds a leading 2-pod axis
    (512 ranks). The caller's process group must have that many ranks."""
    shape, names = production_shape(multi_pod)
    return init_mesh(shape, names, backend=backend)


def make_host_mesh(*, backend: str = "gloo") -> Mesh:
    """Every rank of the caller's process group on one ``data`` axis."""
    import torch.distributed as dist
    return init_mesh((dist.get_world_size(),), ("data",), backend=backend)


def batch_axes_for(mesh: Mesh):
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)
