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
from repro_torch.training.optimizer import (
    AdamWConfig, adamw_update, init_opt_state, leaves, tree_map,
)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    microbatches: int = 1, acc_dtype=torch.float32,
                    remat: bool = False, moe_dispatch: str = "dense"):
    """``microbatches > 1`` splits the batch (``positions`` on its batch
    axis, (3, B, S)) and sums each chunk's gradients divided by their
    number into float32 (``acc_dtype``) buffers, as the JAX step does; one
    microbatch keeps the parameters' dtype, as there. ``remat``
    checkpoints each layer."""

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
                opt_cfg, params, grads, opt_state)
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
