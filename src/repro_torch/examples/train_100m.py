"""End-to-end training run: ~100M-param model, few hundred steps.

A scaled-down gemma-family config (~100M params) trained on the synthetic
Zipf+bigram stream with AdamW and a cosine schedule, then checkpointed in
the JAX package's on-disk format (`repro_torch.training.checkpoint`: the
JAX package's `load_checkpoint` reads it). The twin of the JAX package's
`examples/train_100m.py`, on the card unless ``--device`` names another;
on the CPU pass ``--steps 20`` for a quick look.

    PYTHONPATH=src python -m repro_torch.examples.train_100m [--steps 200] [--device cpu]

``--ckpt`` defaults to a directory under the temporary directory.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

from repro_torch.configs import get_config
from repro_torch.models import resolve_device
from repro_torch.training import AdamWConfig, save_checkpoint, train


def config():
    """The ~100M gemma-family config of the JAX example."""
    return dataclasses.replace(
        get_config("gemma-2b"),
        arch_id="gemma-100m", n_layers=8, d_model=512, n_heads=8,
        n_kv_heads=1, head_dim=64, d_ff=2048, vocab_size=32000)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_100m_ckpt"))
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda or cpu)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = config()
    print(f"{cfg.arch_id}: {cfg.param_count()/1e6:.0f}M params")

    t0 = time.time()
    params, opt, hist = train(
        cfg, steps=args.steps, batch_size=args.batch, seq_len=args.seq,
        log_every=max(args.steps // 20, 1),
        opt_cfg=AdamWConfig(lr=6e-4, warmup_steps=20,
                            total_steps=args.steps),
        device=device)
    seconds = time.time() - t0
    save_checkpoint(args.ckpt, params, cfg, extra={"steps": args.steps,
                                                   "arch": cfg.arch_id})
    print(f"checkpoint -> {args.ckpt}; "
          f"loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")
    return {"cfg": cfg, "params": params, "history": hist,
            "seconds": seconds, "ckpt": args.ckpt, "batch": args.batch,
            "seq": args.seq}


if __name__ == "__main__":
    main()
