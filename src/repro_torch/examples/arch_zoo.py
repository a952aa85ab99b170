"""Architecture zoo tour: one prefill + one decode step per assigned arch.

    PYTHONPATH=src python -m repro_torch.examples.arch_zoo [--arch mixtral-8x7b] [--device cpu]

Each arch runs reduced (the same-family smoke variant), as in the JAX
package's `examples/arch_zoo.py`: a batch of 2 prompts of 32 tokens is
prefilled into a 64-slot cache and decoded one step. On the card the
prefill runs the flash kernel (Mamba-2 layers the SSD-diagonal kernel) and
the decode step the decode kernel; on the CPU their plain versions run.
It runs on the card unless ``--device`` names another.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.models import (
    decode_step, dummy_batch, init_cache, init_params, prefill,
    resolve_device,
)

BATCH, PROMPT, SLOTS = 2, 32, 64


def tour(arch: str, device="cuda", cfg=None, params=None, batch=None):
    """Prefill `batch` (by default `dummy_batch` of 2 x 32 tokens from seed
    0) and decode one greedy step with the reduced `arch`, or with `cfg`,
    `params` where given (a test hands the JAX weights across). Prints the
    JAX example's line. Returns the decode step's logits (B, V), the
    prefill's last logits, the batch and the seconds taken."""
    dev = resolve_device(device)
    cfg = cfg or get_config(arch).reduced()
    if params is None:
        params = init_params(cfg, seed=0, device=dev)
    if batch is None:
        batch = dummy_batch(torch.Generator(device=dev).manual_seed(0), cfg,
                            BATCH, PROMPT, "prefill")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.time()
    cache = init_cache(cfg, batch["tokens"].shape[0], SLOTS, device=dev)
    last, cache = prefill(params, batch, cache, cfg=cfg)
    tok = last.argmax(-1)[:, None]
    extras = {"audio_frames": batch["audio_frames"]} if cfg.enc_dec else None
    logits, cache = decode_step(params, tok, cache, batch["tokens"].shape[1],
                                cfg=cfg, batch_extras=extras)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    full = get_config(arch)
    print(f"{arch:20s} [{cfg.family:6s}] full={full.param_count()/1e9:6.2f}B "
          f"reduced={cfg.param_count()/1e6:6.1f}M  prefill+decode {dt:5.2f}s "
          f"logits={tuple(logits.shape)}", flush=True)
    return {"logits": logits, "last": last, "batch": batch, "seconds": dt}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ASSIGNED_ARCHS))
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda or cpu)")
    args = ap.parse_args(argv)
    return {arch: tour(arch, args.device)
            for arch in ([args.arch] if args.arch else ASSIGNED_ARCHS)}


if __name__ == "__main__":
    main()
