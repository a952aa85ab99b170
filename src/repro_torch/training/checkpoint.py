"""Checkpoints in the JAX package's format: ``weights.npz`` holding the JAX
parameter tree's leaves in ``jax.tree.flatten`` order (dict keys sorted)
as ``arr_<i>``, bfloat16 as its uint16 bits, and ``manifest.json`` with
each leaf's path name and dtype and the caller's ``extra``. The port's
per-layer parameters are stacked into the JAX tree on the way out and
unstacked on the way in (`models.convert`), so a checkpoint that either
package writes loads in the other. No ml_dtypes: the bits are viewed as
``torch.bfloat16``.
"""
from __future__ import annotations

import json
import os
from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.convert import (
    params_from_jax, stack_like_jax, to_numpy,
)


def _flatten(tree, path=()):
    """(name, leaf) pairs in ``jax.tree.flatten`` order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, path + (i,))
    else:
        yield "/".join(str(p) for p in path), tree


def _unflatten(tree, it):
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, it) for v in tree)
    return next(it)


def save_checkpoint(path: str, params: Any, cfg: ModelConfig,
                    extra: dict = None) -> None:
    os.makedirs(path, exist_ok=True)
    flat = list(_flatten(stack_like_jax(params, cfg)))
    arrays, dtypes = {}, []
    for i, (_, leaf) in enumerate(flat):
        arrays[f"arr_{i}"] = arr = to_numpy(leaf)
        dtypes.append("bfloat16" if leaf.dtype == torch.bfloat16
                      else str(arr.dtype))
    np.savez(os.path.join(path, "weights.npz"), **arrays)
    manifest = {"names": [n for n, _ in flat], "n_leaves": len(flat),
                "dtypes": dtypes, "extra": extra or {}}
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)


def load_checkpoint(path: str, like: Any, cfg: ModelConfig,
                    device=None) -> Tuple[Any, dict]:
    """Restore onto `device` in the structure of `like` (the port's
    parameters, or ``params_shapes(cfg)``), checking every leaf's shape and
    casting it to `like`'s dtype. Returns (params, extra)."""
    data = np.load(os.path.join(path, "weights.npz"))
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    jlike = stack_like_jax(like, cfg)
    flat = list(_flatten(jlike))
    if len(flat) != manifest["n_leaves"]:
        raise ValueError(f"the checkpoint holds {manifest['n_leaves']} "
                         f"leaves, the model {len(flat)}")
    dtypes = manifest.get("dtypes", [None] * len(flat))
    leaves = []
    for i, (name, leaf) in enumerate(flat):
        arr = data[f"arr_{i}"]
        if dtypes[i] == "bfloat16" and arr.dtype == np.uint16:
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} in the "
                             f"checkpoint, {tuple(leaf.shape)} in the model")
        leaves.append(t.to(leaf.dtype))
    tree = _unflatten(jlike, iter(leaves))
    return params_from_jax(tree, cfg, device=device), manifest["extra"]
