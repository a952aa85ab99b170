"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \
        --reduced --device cpu --steps 5

Without ``--device`` it trains on the card (``cuda``) and raises when there
is none. ``--microbatches`` accumulates gradients over that many chunks of
the batch; ``--remat`` recomputes each layer in the backward.
"""
import argparse

from repro_torch.configs import get_config, list_archs
from repro_torch.models.parallel import resolve_device
from repro_torch.training import AdamWConfig, train


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true",
                    help="2-layer d_model<=512 variant (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    return ap


def main(argv=None, cfg=None):
    """Train `cfg` (else the named arch) and return (cfg, params, opt_state,
    history)."""
    args = parser().parse_args(argv)
    if cfg is None:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
    dev = resolve_device(args.device)
    print(f"training {cfg.arch_id}: {cfg.param_count()/1e6:.1f}M params on "
          f"{dev}")
    params, opt, hist = train(
        cfg, steps=args.steps, batch_size=args.batch, seq_len=args.seq,
        seed=args.seed, device=dev, microbatches=args.microbatches,
        remat=args.remat, log_every=args.log_every,
        opt_cfg=AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                            total_steps=args.steps))
    print(f"done: loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")
    return cfg, params, opt, hist


if __name__ == "__main__":
    main()
