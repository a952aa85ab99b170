"""The bridge from the JAX package's trees to the port's.

The JAX package stacks each superblock position's parameters (and cache
leaves) along a leading ``n_superblocks`` axis: ``{"head": (...), "sb":
(spec_0, spec_1, ...), "tail": (...)}``. The port keeps one dict per layer
in execution order. These functions take the JAX trees as numpy arrays
(``jax.tree.map(np.asarray, tree)``), so this module needs no JAX, and
unstack them onto `device`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.parallel import resolve_device
from repro_torch.models.transformer import block_program


def to_tensor(a, device) -> torch.Tensor:
    """numpy array -> tensor of the same dtype (bfloat16 arrays included,
    which numpy holds as the ml_dtypes extension type)."""
    a = np.array(a)     # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _unstack(stack, cfg: ModelConfig, device):
    """{"head", "sb", "tail"} -> per-layer list in execution order."""
    prog = block_program(cfg)
    out = [_map(t, lambda a: to_tensor(a, device)) for t in stack["head"]]
    for i in range(prog.n_superblocks):
        for j in range(len(prog.superblock)):
            out.append(_map(stack["sb"][j],
                            lambda a, i=i: to_tensor(np.asarray(a)[i], device)))
    out += [_map(t, lambda a: to_tensor(a, device)) for t in stack["tail"]]
    return out


def params_from_jax(jparams, cfg: ModelConfig, device=None):
    """The JAX ``init_params`` tree (as numpy) -> the port's parameters."""
    dev = resolve_device(device)
    params = {
        "embed": to_tensor(jparams["embed"], dev),
        "layers": _unstack(jparams["stack"], cfg, dev),
        "final_norm": {"scale": to_tensor(jparams["final_norm"]["scale"],
                                          dev)},
    }
    if "unembed" in jparams:
        params["unembed"] = to_tensor(jparams["unembed"], dev)
    return params


def cache_from_jax(jcache, cfg: ModelConfig, device=None):
    """A JAX ``init_cache``/``prefill`` cache (as numpy) -> the port's
    per-layer cache."""
    return _unstack(jcache, cfg, resolve_device(device))
