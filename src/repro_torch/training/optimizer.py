"""AdamW with gradient clipping and a cosine schedule, as the JAX package's.

The state mirrors the parameter tree with float32 moments whatever the
parameters' dtype, and the update runs in float32 and is cast once to each
parameter's dtype; weight decay applies to matrices only (``ndim >= 2``).
``torch.optim.AdamW`` differs on both counts (it decays every tensor, and
updates bf16 parameters in bf16), so the update is written out here. The
parameters and moments are updated in place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    step: int
    m: dict
    v: dict


def leaves(tree) -> list:
    """The tensors of a parameter tree, dict keys in sorted order (the JAX
    package's flattening order)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def cosine_lr(cfg: AdamWConfig, step: int) -> float:
    """Linear warm-up to ``lr``, then a cosine down to ``min_lr_ratio``."""
    warm = min(step / max(cfg.warmup_steps, 1), 1.0)
    prog = min(max((step - cfg.warmup_steps)
                   / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0), 1.0)
    cos = 0.5 * (1.0 + math.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos)


def init_opt_state(params) -> OptState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return OptState(step=0, m=tree_map(zeros, params),
                    v=tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.sqrt(sum(x.float().square().sum() for x in leaves(tree)))


def _adamw_leaf(cfg: AdamWConfig, p, g, m, v, clip, lr, b1c, b2c, ndim):
    """AdamW on one leaf (or its ZeRO chunk), in float32: updates the
    moments in place and returns the new values in float32."""
    g = g.float() * clip
    m.mul_(cfg.b1).add_((1.0 - cfg.b1) * g)
    v.mul_(cfg.b2).add_((1.0 - cfg.b2) * g.square())
    delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
    if ndim >= 2:       # decoupled weight decay on matrices only
        delta = delta + cfg.weight_decay * p.float()
    return p.float() - lr * delta


@torch.no_grad()
def adamw_update_sharded(cfg: AdamWConfig, params, grads, state: OptState,
                         layout):
    """`adamw_update` on this rank's shards with ZeRO-1 moments: ``grads``
    and ``state``'s moments are each leaf's chunk along its data-axis dim
    (`ZeroLayout`); the global norm sums every rank's chunks once; each
    updated chunk is gathered back into the rank's parameter shard."""
    from repro_torch.models import parallel as PAR
    ctx = layout.ctx
    sq = sum(g.float().square().sum() / r for g, r in zip(
        leaves(grads), layout.replicas, strict=True))
    gnorm = torch.sqrt(PAR.all_reduce(sq, ctx, ctx.mesh.axis_names))
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = cosine_lr(cfg, step)
    b1c = 1.0 - cfg.b1 ** step
    b2c = 1.0 - cfg.b2 ** step
    for p, g, m, v, dim in zip(leaves(params), leaves(grads),
                               leaves(state.m), leaves(state.v),
                               layout.dims, strict=True):
        chunk = layout.chunk(p, dim)
        new = _adamw_leaf(cfg, chunk, g, m, v, clip, lr, b1c, b2c, p.ndim)
        if dim is not None:
            new = PAR.all_gather(new.to(p.dtype), ctx, ctx.batch_spec, dim)
        p.copy_(new)
    return params, OptState(step, state.m, state.v), {
        "grad_norm": gnorm, "lr": lr}


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state: OptState):
    """One AdamW step on `params` in place. The steps count from 1; the
    gradients are clipped to a global norm of ``grad_clip``, and the norm
    reported is the one before clipping. Returns (params, state', metrics
    {"grad_norm" (a tensor), "lr"})."""
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = cosine_lr(cfg, step)
    b1c = 1.0 - cfg.b1 ** step
    b2c = 1.0 - cfg.b2 ** step
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.m),
                          leaves(state.v), strict=True):
        p.copy_(_adamw_leaf(cfg, p, g, m, v, clip, lr, b1c, b2c, p.ndim))
    return params, OptState(step, state.m, state.v), {
        "grad_norm": gnorm, "lr": lr}
