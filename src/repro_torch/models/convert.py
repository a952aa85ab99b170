"""The bridge between the JAX package's trees and the port's.

The JAX package stacks each superblock position's parameters (and cache
leaves) along a leading ``n_superblocks`` axis: ``{"head": (...), "sb":
(spec_0, spec_1, ...), "tail": (...)}``, and an encoder's layers along a
leading ``n_encoder_layers`` axis. The port keeps one dict per layer in
execution order. `params_from_jax` and `cache_from_jax` take the JAX trees
as numpy arrays (``jax.tree.map(np.asarray, tree)``), so this module needs
no JAX, and unstack them onto `device`; `params_to_jax` stacks the port's
parameters back into the JAX tree. Every leaf keeps its dtype: the float32
leaves of a bf16 tree (norm scales, the RG-LRU gates and ``lam``, the
recurrent state ``h``) stay float32.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.parallel import resolve_device
from repro_torch.models.transformer import block_program


def to_tensor(a, device) -> torch.Tensor:
    """numpy array (or tensor) -> a new tensor of the same dtype on
    `device` (bfloat16 arrays included, which numpy holds as the ml_dtypes
    extension type)."""
    if isinstance(a, torch.Tensor):
        return a.to(device, copy=True)
    a = np.array(a)     # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def _unstack(stack, cfg: ModelConfig, device):
    """{"head", "sb", "tail"} -> per-layer list in execution order."""
    prog = block_program(cfg)
    out = [_map(t, lambda a: to_tensor(a, device)) for t in stack["head"]]
    for i in range(prog.n_superblocks):
        for j in range(len(prog.superblock)):
            out.append(_unstack_one(stack["sb"][j], i, device))
    out += [_map(t, lambda a: to_tensor(a, device)) for t in stack["tail"]]
    return out


def _unstack_one(tree, i, device):
    """Entry i of a tree stacked along its leading axis."""
    return _map(tree, lambda a: to_tensor(a[i], device))


def _stack(trees):
    """Per-layer trees -> one tree stacked along a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def params_from_jax(jparams, cfg: ModelConfig, device=None):
    """The JAX ``init_params`` tree (as numpy) -> the port's parameters."""
    dev = resolve_device(device)
    params = {
        "embed": to_tensor(jparams["embed"], dev),
        "layers": _unstack(jparams["stack"], cfg, dev),
        "final_norm": {"scale": to_tensor(jparams["final_norm"]["scale"],
                                          dev)},
    }
    for key in ("unembed", "vision_proj"):
        if key in jparams:
            params[key] = to_tensor(jparams[key], dev)
    if cfg.enc_dec:
        enc = jparams["encoder"]
        params["encoder"] = {
            "layers": [_unstack_one(enc["layers"], i, dev)
                       for i in range(cfg.n_encoder_layers)],
            "norm": {"scale": to_tensor(enc["norm"]["scale"], dev)}}
    return params


def stack_like_jax(params, cfg: ModelConfig):
    """The port's parameters in the JAX ``init_params`` tree: superblock
    layers and encoder layers stacked along a leading axis (copies), every
    other leaf the port's own tensor. Tuples where JAX has tuples."""
    prog = block_program(cfg)
    layers = params["layers"]
    nh, nsb = len(prog.head), len(prog.superblock)
    body = nh + nsb * prog.n_superblocks
    stack = {
        "head": tuple(layers[:nh]),
        "sb": tuple(_stack(layers[nh + j:body:nsb]) for j in range(nsb)),
        "tail": tuple(layers[body:]),
    }
    out = {k: v for k, v in params.items() if k not in ("layers", "encoder")}
    out["stack"] = stack
    if cfg.enc_dec:
        out["encoder"] = {"layers": _stack(params["encoder"]["layers"]),
                          "norm": params["encoder"]["norm"]}
    return out


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor's values on the host; a bfloat16 tensor as its raw bits, a
    uint16 array (numpy has no bfloat16 of its own)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def params_to_jax(params, cfg: ModelConfig):
    """The port's parameters -> the JAX ``init_params`` tree as numpy
    arrays (bfloat16 leaves as their uint16 bits, `to_numpy`), the inverse
    of `params_from_jax`."""
    return _map(stack_like_jax(params, cfg), to_numpy)


def cache_from_jax(jcache, cfg: ModelConfig, device=None):
    """A JAX ``init_cache``/``prefill`` cache (as numpy) -> the port's
    per-layer cache."""
    return _unstack(jcache, cfg, resolve_device(device))
