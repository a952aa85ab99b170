"""Sharding rules for batches and KV/recurrent caches, as spec trees.

Parameters follow `repro_torch.models.parallel.param_specs`; this module
covers the runtime state: input batches and decode caches, by leaf name and
shape (divisibility checked), as the JAX package's ``launch/shardings.py``:

  k/v/cross_k/cross_v  (B, S, Hkv, hd): B -> batch axes; Hkv -> model (else,
      for k/v with the batch sharded, S -> model, the layout of the
      context-parallel decode; else hd -> model); for the long-context
      decode shape (B = 1, S = max_seq) with ``context_parallel`` the cache
      *sequence* goes over "data".
  ckv/krope            (B, S, r): B -> batch; r -> model.
  state                (B, nh, hd, ds): B -> batch; nh -> model.
  conv                 (B, k, C): B -> batch; C -> model.
  h                    (B, dr): B -> batch; dr -> model.

The port keeps one cache dict per layer (the JAX package stacks the
superblock's layers along a leading axis): a port leaf's spec is the JAX
leaf's without that axis.
"""
from __future__ import annotations

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import model as M
from repro_torch.models.parallel import ParallelContext, map_trees


def _batch_axis_tree(cfg: ModelConfig, max_seq: int):
    """Per cache leaf, the dim whose size is the batch (-1 if none)."""
    c1 = M.init_cache(cfg, 1, max_seq, device="meta")
    c2 = M.init_cache(cfg, 2, max_seq, device="meta")
    return map_trees(
        lambda a, b: next((i for i, (x, y) in enumerate(
            zip(a.shape, b.shape, strict=True)) if x != y), -1), c1, c2)


class _Named:
    def __init__(self, name, leaf):
        self.name, self.leaf = name, leaf


def _with_names(tree, name=None):
    """A `_Named` (nearest dict key, leaf) in place of each leaf."""
    if isinstance(tree, dict):
        return {k: _with_names(v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_with_names(v, name) for v in tree)
    return _Named(name, tree)


def cache_specs_tree(cfg: ModelConfig, ctx: ParallelContext, batch: int,
                     max_seq: int, context_parallel: bool = False):
    """Spec tree matching ``init_cache(cfg, batch, max_seq)``."""
    shapes = M.init_cache(cfg, batch, max_seq, device="meta")
    baxes = _batch_axis_tree(cfg, max_seq)
    msize = ctx.axis_size(ctx.model_axis)
    bdiv = ctx.batch_size_divisor
    cp_size = ctx.axis_size("data") if "data" in (
        ctx.mesh.axis_names if ctx.mesh is not None else ()) else 1

    def rule(named, bax):
        name, leaf = named.name, named.leaf
        shape = tuple(leaf.shape)
        spec = [None] * len(shape)
        if bax >= 0 and shape[bax] % bdiv == 0 and shape[bax] > 1:
            spec[bax] = ctx.batch_spec
        if name in ("k", "v", "cross_k", "cross_v"):
            s_dim, h_dim, d_dim = bax + 1, bax + 2, bax + 3
            if (context_parallel and spec[bax] is None
                    and shape[s_dim] == max_seq
                    and shape[s_dim] % cp_size == 0):
                spec[s_dim] = "data"
            if shape[h_dim] % msize == 0:
                spec[h_dim] = ctx.model_axis
            elif (name in ("k", "v") and spec[s_dim] is None
                    and spec[bax] is not None
                    and shape[s_dim] % msize == 0):
                # matches the context-parallel decode: a batch-sharded
                # decode cache splits its sequence over `model`
                spec[s_dim] = ctx.model_axis
            elif shape[d_dim] % msize == 0:
                spec[d_dim] = ctx.model_axis
        elif name in ("ckv", "krope"):
            r_dim = len(shape) - 1
            if shape[r_dim] % msize == 0:
                spec[r_dim] = ctx.model_axis
        elif name == "state":
            nh_dim = bax + 1
            if shape[nh_dim] % msize == 0:
                spec[nh_dim] = ctx.model_axis
        elif name in ("conv", "h"):
            last = len(shape) - 1
            if shape[last] % msize == 0:
                spec[last] = ctx.model_axis
        if ctx.mesh is None:
            return (None,) * len(shape)
        return tuple(spec)

    return map_trees(rule, _with_names(shapes), baxes)


def batch_shardings(cfg: ModelConfig, ctx: ParallelContext,
                    shape: InputShape):
    """Specs matching ``input_specs(cfg, shape)``: the batch dim over the
    data axes where it divides (``positions`` is (3, B, S))."""
    specs = M.input_specs(cfg, shape)
    bdiv = ctx.batch_size_divisor

    def rule(name, leaf):
        spec = [None] * leaf.ndim
        bdim = 1 if name == "positions" else 0
        if leaf.shape[bdim] % bdiv == 0 and leaf.shape[bdim] > 1 \
                and ctx.mesh is not None:
            spec[bdim] = ctx.batch_spec
        return tuple(spec)

    return {k: rule(k, v) for k, v in specs.items()}
