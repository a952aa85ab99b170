"""Device choice for a single-device run.

The JAX package threads a ``ParallelContext`` (mesh, sharding helpers)
through every model function. On one card the port needs only the device:
model functions take it from their tensors, and the entry points that
create tensors (``init_params``, ``init_cache``, ``ServingEngine``, the
launcher) resolve it here. Meshes and sharding wait for the distribution
slice.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is asked for (or defaulted to) and there is
    no card: the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev
