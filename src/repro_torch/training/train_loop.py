"""The training step and a small training loop, as the JAX package's.

`make_train_step` returns ``train_step(params, opt_state, batch) ->
(params, opt_state, metrics)``: the loss's gradients by autograd (through
the flash and SSD kernels' autograd Functions on the card), accumulated
over microbatches in ``acc_dtype`` buffers, then one AdamW update of the
parameters in place. The two halves run inside ``torch.profiler`` ranges
(``train_step.grads``, ``train_step.adamw``), which a trace reads to split
a step's device time; with no profiler running they cost a few
microseconds a step.
"""
from __future__ import annotations

import time
from typing import Optional

import torch
import torch.profiler

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.models.parallel import resolve_device
from repro_torch.models import parallel as PAR
from repro_torch.training.optimizer import (
    AdamWConfig, OptState, adamw_update, adamw_update_sharded,
    init_opt_state, leaves, tree_map,
)


def _spec_leaves(tree) -> list:
    """The specs of a spec tree in `leaves` order (a spec is a tuple)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _spec_leaves(tree[k])]
    if isinstance(tree, list):
        return [t for v in tree for t in _spec_leaves(v)]
    return [tree]


class ZeroLayout:
    """Where each parameter's AdamW moments (and its reduced gradient) are
    cut over the data axes: the dim that `parallel.opt_state_shardings` adds
    the data axes to (None: held whole on every data rank), and how many
    ranks hold each chunk (the global norm counts a chunk once); and
    which parameters take weight decay (`models.model.decayed_leaves`)."""

    def __init__(self, cfg: ModelConfig, ctx):
        shapes = M.params_shapes(cfg)
        self.decayed = M.decayed_leaves(cfg)
        pspecs = _spec_leaves(PAR.param_specs(shapes, ctx))
        mspecs = _spec_leaves(PAR.opt_state_shardings(shapes, ctx))
        self.ctx = ctx
        self.dims = []
        self.replicas = []
        world = ctx.mesh.size
        for ps, ms in zip(pspecs, mspecs, strict=True):
            dim = next((d for d, (a, b) in enumerate(zip(ps, ms, strict=True))
                        if a is None and b is not None), None)
            self.dims.append(dim)
            held = 1
            for e in ms:
                if e is not None:
                    held *= ctx.axis_size(e)
            self.replicas.append(world // held)

    def chunk(self, t, dim):
        """This rank's chunk of a parameter shard along its data dim."""
        if dim is None:
            return t
        spec = [None] * t.ndim
        spec[dim] = self.ctx.batch_spec
        return PAR.local_view(t, tuple(spec), self.ctx)

    def reduce(self, g, dim):
        """A rank's gradient shard summed over the data axes, cut to its
        chunk (a reduce-scatter; an all-reduce where the moments are whole
        on every data rank)."""
        if self.ctx.batch_size_divisor == 1:
            return g
        if dim is None:
            return PAR.all_reduce(g, self.ctx, self.ctx.batch_spec)
        return PAR.reduce_scatter(g, self.ctx, self.ctx.batch_spec, dim)

    def init_opt_state(self, params) -> OptState:
        def zeros(p, dim):
            return torch.zeros(self.chunk(p, dim).shape, dtype=torch.float32,
                               device=p.device)
        flat = leaves(params)
        m = [zeros(p, d) for p, d in zip(flat, self.dims, strict=True)]
        v = [zeros(p, d) for p, d in zip(flat, self.dims, strict=True)]
        return OptState(step=0, m=_unflatten(params, m),
                        v=_unflatten(params, v))


def _unflatten(tree, flat):
    """`flat` (in `leaves` order) in the structure of `tree`."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            out = {k: None for k in t}
            for k in sorted(t):
                out[k] = build(t[k])
            return out
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)
    return build(tree)


def init_opt_state_sharded(params, cfg: ModelConfig, ctx) -> OptState:
    """AdamW state of this rank's parameter shards, the moments cut over the
    data axes as `parallel.opt_state_shardings` says (ZeRO-1)."""
    return ZeroLayout(cfg, ctx).init_opt_state(params)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    microbatches: int = 1, acc_dtype=torch.float32,
                    remat: bool = False, moe_dispatch: str = "dense",
                    ctx=None):
    """``microbatches > 1`` splits the batch (``positions`` on its batch
    axis, (3, B, S)) and sums each chunk's gradients divided by their
    number into float32 (``acc_dtype``) buffers, as the JAX step does; one
    microbatch keeps the parameters' dtype, as there. ``remat``
    checkpoints each layer.

    Under a mesh (``ctx``, which then gives ``remat`` and the MoE dispatch)
    the step takes this rank's parameter shards, the global batch and the
    state of `init_opt_state_sharded`: each rank differentiates the loss on
    its rows, reduce-scatters the gradients over the data axes into the
    moments' layout (ZeRO-1, accumulated there over microbatches), updates
    its chunks and gathers them back into its parameter shards."""
    if PAR.is_sharded(ctx):
        return _make_sharded_step(cfg, opt_cfg, microbatches, acc_dtype,
                                  ctx)
    decayed = M.decayed_leaves(cfg)

    def grads_of(params, batch):
        shadow = tree_map(lambda t: t.detach().requires_grad_(True), params)
        total, metrics = M.loss_fn(shadow, batch, cfg=cfg, remat=remat,
                                   moe_dispatch=moe_dispatch)
        flat = leaves(shadow)
        grads = torch.autograd.grad(total, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(flat, grads, strict=True)]
        return total.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def train_step(params, opt_state, batch):
        with torch.profiler.record_function("train_step.grads"):
            total, metrics, grads = accumulate(params, batch)
        with torch.profiler.record_function("train_step.adamw"):
            params, opt_state, opt_metrics = adamw_update(
                opt_cfg, params, grads, opt_state, decayed)
        metrics = dict(metrics, **opt_metrics)
        metrics["total_loss"] = total
        return params, opt_state, metrics

    def accumulate(params, batch):
        if microbatches == 1:
            total, metrics, grads = grads_of(params, batch)
        else:
            b = batch["tokens"].shape[0]
            if b % microbatches:
                raise ValueError(f"batch {b} does not split into "
                                 f"{microbatches} microbatches")
            mb = b // microbatches
            grads = [torch.zeros(p.shape, dtype=acc_dtype, device=p.device)
                     for p in leaves(params)]
            loss = aux = 0.0
            for i in range(microbatches):
                rows = slice(i * mb, (i + 1) * mb)
                chunk = {k: v[:, rows] if k == "positions" else v[rows]
                         for k, v in batch.items()}
                _, m, g = grads_of(params, chunk)
                for acc, gi in zip(grads, g, strict=True):
                    acc.add_(gi.to(acc_dtype) / microbatches)
                loss = loss + m["loss"] / microbatches
                aux = aux + m["moe_aux_loss"] / microbatches
            total = loss
            metrics = {"loss": loss, "moe_aux_loss": aux}
        return total, metrics, grads

    return train_step


def _make_sharded_step(cfg, opt_cfg, microbatches, acc_dtype, ctx):
    layout = ZeroLayout(cfg, ctx)

    def grads_of(params, batch):
        shadow = tree_map(lambda t: t.detach().requires_grad_(True), params)
        total, metrics = M.loss_fn(shadow, batch, cfg=cfg, ctx=ctx)
        flat = leaves(shadow)
        grads = torch.autograd.grad(total, flat, allow_unused=True)
        grads = [layout.reduce(torch.zeros_like(p) if g is None else g, d)
                 for p, g, d in zip(flat, grads, layout.dims, strict=True)]
        return total.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def train_step(params, opt_state, batch):
        b = batch["tokens"].shape[0]
        if b % (microbatches * ctx.batch_size_divisor):
            raise ValueError(f"batch {b} does not split into {microbatches} "
                             f"microbatches over {ctx.batch_size_divisor} "
                             f"data ranks")
        with torch.profiler.record_function("train_step.grads"):
            if microbatches == 1:
                total, metrics, grads = grads_of(params, batch)
            else:
                mb = b // microbatches
                grads = None
                loss = aux = 0.0
                for i in range(microbatches):
                    rows = slice(i * mb, (i + 1) * mb)
                    chunk = {k: v[:, rows] if k == "positions" else v[rows]
                             for k, v in batch.items()}
                    _, m, g = grads_of(params, chunk)
                    if grads is None:
                        grads = [torch.zeros(x.shape, dtype=acc_dtype,
                                             device=x.device) for x in g]
                    for acc, gi in zip(grads, g, strict=True):
                        acc.add_(gi.to(acc_dtype) / microbatches)
                    loss = loss + m["loss"] / microbatches
                    aux = aux + m["moe_aux_loss"] / microbatches
                total = loss
                metrics = {"loss": loss, "moe_aux_loss": aux}
        with torch.profiler.record_function("train_step.adamw"):
            params, opt_state, opt_metrics = adamw_update_sharded(
                opt_cfg, params, _unflatten(params, grads), opt_state,
                layout)
        metrics = dict(metrics, **opt_metrics)
        metrics["total_loss"] = total
        return params, opt_state, metrics

    return train_step


def train(cfg: ModelConfig, steps: int = 50, batch_size: int = 8,
          seq_len: int = 128, opt_cfg: Optional[AdamWConfig] = None,
          seed: int = 0, log_every: int = 10, data_iter=None, device=None,
          microbatches: int = 1, remat: bool = False):
    """Train from random weights on `device` (CUDA unless named) over the
    synthetic token stream (or ``data_iter``'s numpy batches), printing the
    JAX loop's line every ``log_every`` steps and at the last. Returns
    (params, opt_state, history)."""
    from repro_torch.training.data import DataConfig, SyntheticLM

    dev = resolve_device(device)
    if cfg.enc_dec and data_iter is None:
        raise ValueError(
            f"{cfg.arch_id} is an encoder-decoder model and the synthetic "
            f"stream holds tokens alone, no audio frames (as the JAX "
            f"loop's); pass a data_iter whose batches carry "
            f"'audio_frames', or drive make_train_step with "
            f"repro_torch.models.dummy_batch")
    opt_cfg = opt_cfg or AdamWConfig(total_steps=steps)
    params = M.init_params(cfg, seed=seed, device=dev)
    opt_state = init_opt_state(params)
    step_fn = make_train_step(cfg, opt_cfg, microbatches=microbatches,
                              remat=remat)
    if data_iter is None:
        data = SyntheticLM(DataConfig(cfg.vocab_size, seq_len, batch_size,
                                      seed=seed))
        data_iter = data.batches()

    def to_device(k, v):
        t = torch.from_numpy(v).to(dev)
        return t.long() if k in ("tokens", "labels") else t

    history = []
    t0 = time.time()
    for i in range(steps):
        batch = {k: to_device(k, v) for k, v in next(data_iter).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if i % log_every == 0 or i == steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = i
            m["elapsed_s"] = time.time() - t0
            history.append(m)
            print(f"step {i:4d} loss={m['loss']:.4f} "
                  f"gnorm={m['grad_norm']:.2f} lr={m['lr']:.2e}")
    return params, opt_state, history
