"""Serving launcher: continuous-batching engine over synthetic requests.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \
        --requests 16 --max-new 8

runs one engine at the full width of `--arch` on the card; `--reduced`
takes the same-family smoke variant and `--device cpu` the plain PyTorch
path on the CPU. With `--policy NAME` the launcher instead serves through a
PerLLM fleet (2 reduced edge engines + 1 reduced cloud engine) scheduled by
the named policy from the registry (see
`repro_torch.core.available_policies()`):

    PYTHONPATH=src python -m repro_torch.launch.serve --policy perllm \
        --requests 12

`--paged [KV_BLOCKS]` runs the engine(s) on the paged KV cache: admission
allocates block-pool pages (and stalls on exhaustion) instead of relying on
the dense `max_batch x max_seq` reservation; evicted requests keep their
prefill. `--arch mamba2-2.7b` serves the Mamba-2 family (its prefill runs
the SSD-diagonal kernel on the card), `--arch deepseek-moe-16b` (and
`mixtral-8x7b --reduced`, whose 32 layers do not fit one card) the MoE
family, `--arch minicpm3-4b` the MLA family (its prefill runs the flash
kernel at head_dim 96), `--arch recurrentgemma-2b` the RG-LRU hybrid (its
attention layers decode at 10 q-heads a kv-head) and `--arch qwen2-vl-2b`
the M-RoPE family (text only: the launcher passes no vision embeddings);
`--prompt-len LO HI` draws the prompt lengths from [LO, HI).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.models import init_params, resolve_device
from repro_torch.serving import ServingEngine


def run_fleet(args):
    """Edge-cloud fleet scheduled by a registry policy (`--policy`).
    Returns the drained `PerLLMServer`."""
    from repro_torch.cluster import paper_testbed
    from repro_torch.core import available_policies, make_policy
    from repro_torch.serving.perllm_server import PerLLMServer

    device = resolve_device(args.device)
    # specs carry the engines' block granularity so the C5 constraint's
    # blocks-needed estimate uses the same units as the engine pools
    specs = paper_testbed(n_edge=2, kv_block_tokens=args.kv_block_tokens)
    try:
        policy = make_policy(args.policy, len(specs))
    except KeyError:
        raise SystemExit(f"unknown policy {args.policy!r}; available: "
                         + ", ".join(available_policies())) from None
    edge_cfg = get_config("gemma-2b").reduced(n_layers=2, d_model=64,
                                              vocab_size=256)
    cloud_cfg = get_config("gemma3-12b").reduced(n_layers=2, d_model=128,
                                                 vocab_size=256)
    kv = _kv_kwargs(args)
    engines = [ServingEngine(edge_cfg, init_params(edge_cfg, device=device),
                             max_batch=2, max_seq=64, device=device, **kv)
               for _ in range(2)]
    engines.append(ServingEngine(cloud_cfg,
                                 init_params(cloud_cfg, device=device),
                                 max_batch=4, max_seq=64, device=device,
                                 **kv))
    srv = PerLLMServer(specs, engines, scheduler=policy)
    rng = np.random.default_rng(0)
    t0 = time.time()
    for _ in range(args.requests):
        plen = int(rng.integers(4, 16))
        srv.submit(list(rng.integers(0, 256, plen)),
                   max_new_tokens=args.max_new)
    srv.run_until_idle()
    dt = time.time() - t0
    s = srv.stats
    if not s["served"]:
        print(f"{policy.name}: served 0 requests in {dt:.1f}s on {device}")
        return srv
    print(f"{policy.name}: served {s['served']} requests in {dt:.1f}s on "
          f"{device} — deadline_met={s['deadline_met']*100:.0f}% "
          f"mean_latency={s['mean_latency']:.2f}s "
          f"per_server={s['per_server']}")
    return srv


def run_single(args, cfg=None):
    """One engine at the width of `--arch`, or of `cfg` where one is given
    (a config the flags cannot name, such as a model with its depth cut to
    fit one card). Returns (engine, completed requests, seconds)."""
    device = resolve_device(args.device)
    if cfg is None:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
    params = init_params(cfg, device=device)
    eng = ServingEngine(cfg, params, max_batch=args.max_batch,
                        max_seq=args.max_seq, device=device,
                        temperature=args.temperature, **_kv_kwargs(args))
    rng = np.random.default_rng(0)
    t0 = time.time()
    lo, hi = args.prompt_len
    for _ in range(args.requests):
        plen = int(rng.integers(lo, hi))
        eng.submit(list(rng.integers(0, cfg.vocab_size, plen)),
                   max_new_tokens=args.max_new)
    done = eng.run_until_idle()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    toks = sum(len(r.generated) for r in done)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "CPU")
    print(f"{cfg.arch_id}: served {len(done)} requests, {toks} tokens in "
          f"{dt:.1f}s ({toks/dt:.1f} tok/s on {where})")
    return eng, done, dt


def _kv_kwargs(args) -> dict:
    if args.paged is None:
        return {}
    return dict(paged=True,
                kv_blocks=args.paged if args.paged > 0 else None,
                kv_block_tokens=args.kv_block_tokens)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda, cuda:N or cpu)")
    ap.add_argument("--policy", default=None,
                    help="serve through an edge-cloud fleet scheduled by "
                         "this registered policy (perllm, fineinfer, ...)")
    ap.add_argument("--paged", type=int, nargs="?", const=0, default=None,
                    metavar="KV_BLOCKS",
                    help="paged KV cache: allocate block-pool pages at "
                         "admission (optional pool size in blocks; bare "
                         "--paged sizes the pool to the dense equivalent)")
    ap.add_argument("--kv-block-tokens", type=int, default=16,
                    help="tokens of KV per block in --paged mode")
    ap.add_argument("--prompt-len", type=int, nargs=2, default=(4, 24),
                    metavar=("LO", "HI"),
                    help="single engine: prompt lengths drawn from [LO, HI)")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    if args.policy:
        return run_fleet(args)
    return run_single(args)


if __name__ == "__main__":
    main()
