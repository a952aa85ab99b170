from repro_torch.models.model import (
    decode_step, dummy_batch, forward, init_cache, init_params, loss_fn,
    params_shapes, prefill,
)
from repro_torch.models.parallel import resolve_device

__all__ = ["decode_step", "dummy_batch", "forward", "init_cache",
           "init_params", "loss_fn", "params_shapes", "prefill",
           "resolve_device"]
