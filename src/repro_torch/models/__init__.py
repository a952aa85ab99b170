from repro_torch.models.model import (
    decode_step, forward, init_cache, init_params, prefill,
)
from repro_torch.models.parallel import resolve_device

__all__ = ["decode_step", "forward", "init_cache", "init_params", "prefill",
           "resolve_device"]
