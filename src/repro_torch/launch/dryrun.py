"""Dry run of every (arch, shape) on the production mesh, on the CPU.

One process stands for rank 0 of the 256-rank (16, 16) or 512-rank
(2, 16, 16) mesh: a fake process group (``FakeStore``, backend "fake")
gives it the mesh's groups, and every tensor is a meta tensor, so nothing
full-size is allocated and no collective moves data. The sharded step (the
train step, prefill or a decode step) runs on rank 0's shards, and the
report gives, per rank:

* the argument bytes (parameters, optimizer state, batch, cache) from the
  local shard shapes;
* the peak of the step's temporaries (``MemTracker`` over the meta
  allocations; each kernel wrapper allocates its outputs alone, as the
  card kernels do);
* the collectives' bytes by kind, from the helpers' counters (an
  all-reduce counted twice, ring traffic, as the JAX package counts it);

and, from `costmodel.step_cost` on the unsharded step, ``global_flops`` and
``global_bytes_unfused``. There is no compile step and no XLA cost
analysis. A pair that raises is reported and the run goes on.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--json out.jsonl]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time
from typing import Optional

import torch

from repro_torch.configs import (ASSIGNED_ARCHS, INPUT_SHAPES, InputShape,
                                 ModelConfig, get_config, shape_applicable)
from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ssd_diag as _ssd
from repro_torch.launch.costmodel import step_cost
from repro_torch.launch.mesh import (batch_axes_for, make_production_mesh,
                                    production_shape)
from repro_torch.models import model as M
from repro_torch.models import parallel as PAR
from repro_torch.training.optimizer import (AdamWConfig, init_opt_state,
                                            leaves)
from repro_torch.training.train_loop import ZeroLayout, make_train_step

COLLECTIVES = PAR.KINDS
_MESHES: dict = {}


def collective_bytes(counts: dict) -> dict:
    """Bytes by kind from `parallel.collective_counts` (an all-reduce
    counted twice: a ring moves a reduce-scatter's and an all-gather's),
    and their total."""
    out = {k: float(counts[k]["bytes"]) * (2.0 if k == "all-reduce" else 1.0)
           for k in COLLECTIVES}
    out["total"] = sum(out[k] for k in COLLECTIVES)
    return out


def _mesh(multi_pod: bool) -> PAR.Mesh:
    """The production mesh over a fake process group of its size, in
    which this process is rank 0 (kept for later pairs)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    shape, _ = production_shape(multi_pod)
    world = math.prod(shape)
    if multi_pod in _MESHES and dist.is_initialized() \
            and dist.get_world_size() == world:
        return _MESHES[multi_pod]
    if dist.is_initialized():
        dist.destroy_process_group()
        _MESHES.clear()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    _MESHES[multi_pod] = make_production_mesh(multi_pod=multi_pod)
    return _MESHES[multi_pod]


def close() -> None:
    """Drop the fake process group (and the meshes over it)."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    _MESHES.clear()


def make_context(mesh, **kw) -> PAR.ParallelContext:
    return PAR.ParallelContext(mesh=mesh, batch_axes=batch_axes_for(mesh),
                               model_axis="model", **kw)


def _meta_like(tree, specs, ctx):
    return PAR.map_trees(
        lambda t, sp: torch.empty(PAR.local_shape(t.shape, sp, ctx),
                                  dtype=t.dtype, device="meta"), tree, specs)


def _batch(cfg: ModelConfig, shape: InputShape):
    """The global batch as meta tensors (token ids as int64)."""
    out = M.input_specs(cfg, shape)
    for k in ("tokens", "labels"):
        if k in out:
            out[k] = torch.empty(out[k].shape, dtype=torch.long,
                                 device="meta")
    return out


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def build(cfg: ModelConfig, shape: InputShape, ctx: PAR.ParallelContext,
          microbatches: int = 1):
    """(sharded step on rank 0's shards, its arguments, their bytes by
    kind)."""
    pspecs = PAR.param_specs(M.params_shapes(cfg), ctx)
    params = _meta_like(M.params_shapes(cfg), pspecs, ctx)
    batch = _batch(cfg, shape)
    local_batch = {k: ctx.shard_batch(v, 1 if k == "positions" else 0)
                   for k, v in batch.items()}
    sizes = {"params": _nbytes(params), "batch": _nbytes(local_batch)}
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        opt = ZeroLayout(cfg, ctx).init_opt_state(params)
        sizes["opt_state"] = _nbytes(opt.m) + _nbytes(opt.v)
        step = make_train_step(cfg, AdamWConfig(), microbatches=microbatches,
                               ctx=ctx)
        return step, (params, opt, batch), sizes
    cache = M.init_cache(cfg, b, s, device="meta", ctx=ctx,
                         context_parallel=shape.kind == "decode" and b == 1)
    sizes["cache"] = _nbytes(list(cache))
    if shape.kind == "prefill":
        return (lambda p, x, c: M.prefill(p, x, c, cfg=cfg, ctx=ctx),
                (params, batch, cache), sizes)
    extras = {k: v for k, v in batch.items() if k != "tokens"}
    return (lambda p, t, c: M.decode_step(
        p, t, c, s - 1, cfg=cfg, ctx=ctx, batch_extras=extras or None),
        (params, batch["tokens"], cache), sizes)


def _global_step(cfg: ModelConfig, shape: InputShape, remat: bool):
    """The unsharded step and its arguments, for the cost model."""
    params = M.params_shapes(cfg)
    batch = _batch(cfg, shape)
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        step = make_train_step(cfg, AdamWConfig(), remat=remat)
        return step, (params, init_opt_state(params), batch)
    cache = M.init_cache(cfg, b, s, device="meta")
    if shape.kind == "prefill":
        return (lambda p, x, c: M.prefill(p, x, c, cfg=cfg),
                (params, batch, cache))
    extras = {k: v for k, v in batch.items() if k != "tokens"}
    return (lambda p, t, c: M.decode_step(p, t, c, s - 1, cfg=cfg,
                                          batch_extras=extras or None),
            (params, batch["tokens"], cache))


@contextlib.contextmanager
def _kernel_outputs_only():
    """Within it the kernel wrappers return their outputs alone, empty, as
    the card kernels allocate them: on meta tensors they would otherwise run
    their plain versions, whose temporaries (a whole score matrix) are not
    the step's. The cost model keeps the plain versions."""
    def flash(q, k, v, *, return_lse=False, **_):
        out = torch.empty_like(q)
        return (out, q.new_empty(q.shape[:3], dtype=torch.float32)) \
            if return_lse else out

    def decode(q, k, v, valid_len, *, return_lse=False, **_):
        out = torch.empty_like(q)
        return (out, q.new_empty(q.shape[:2], dtype=torch.float32)) \
            if return_lse else out

    def ssd(x, *_, **__):
        return torch.empty_like(x)

    saved = _fa.flash_attention, _dec.decode_attention, _ssd.ssd_diag
    _fa.flash_attention, _dec.decode_attention, _ssd.ssd_diag = \
        flash, decode, ssd
    try:
        yield
    finally:
        _fa.flash_attention, _dec.decode_attention, _ssd.ssd_diag = saved


def run_one(arch: str, shape_name: str, multi_pod: bool = False,
            verbose: bool = True, ctx_overrides: Optional[dict] = None,
            microbatches: int = 1):
    from torch.distributed._tools.mem_tracker import MemTracker
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    if not shape_applicable(cfg, shape):
        return {"arch": arch, "shape": shape_name, "skipped": True,
                "reason": "long_500k needs sub-quadratic attention"}
    mesh = _mesh(multi_pod)
    ctx = make_context(mesh, **(ctx_overrides or {}))
    t0 = time.time()
    fn, args, sizes = build(cfg, shape, ctx, microbatches)
    PAR.reset_collectives()
    tracker = MemTracker()
    with _kernel_outputs_only(), tracker:
        fn(*args)
    peak = tracker.get_tracker_snapshot("peak")
    counts = PAR.collective_counts()
    t_step = time.time() - t0
    temp = sum(v.get("Total", 0) for v in peak.values())
    gfn, gargs = _global_step(cfg, shape, ctx.remat)
    gc = step_cost(gfn, *gargs)
    report = {
        "arch": arch,
        "shape": shape_name,
        "mesh": list(mesh.devices_shape),
        "multi_pod": multi_pod,
        "n_devices": mesh.size,
        "step_s": round(t_step, 2),
        "param_bytes": sizes["params"],
        "opt_state_bytes": sizes.get("opt_state", 0),
        "batch_bytes": sizes["batch"],
        "cache_bytes": sizes.get("cache", 0),
        "argument_size_in_bytes": sum(sizes.values()),
        "temp_peak_bytes": int(temp),
        "collective_bytes": collective_bytes(counts),
        "collective_calls": {k: counts[k]["calls"] for k in COLLECTIVES},
        "global_flops": gc["flops"],
        "global_bytes_unfused": gc["bytes"],
    }
    if verbose:
        print(json.dumps(report, indent=2, default=float))
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(INPUT_SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--json", default=None, help="append reports to file")
    ap.add_argument("--expert-parallel", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1,
                    help="gradient-accumulation chunks for train shapes")
    ap.add_argument("--moe-dispatch", default=None,
                    choices=["dense", "capacity", "ep_a2a"],
                    help="MoE dispatch (dense, capacity, or the "
                         "expert-parallel all-to-all)")
    args = ap.parse_args(argv)

    overrides = {}
    if args.expert_parallel:
        overrides["moe_expert_parallel"] = True
    if args.moe_dispatch:
        overrides["moe_dispatch"] = args.moe_dispatch

    archs = ASSIGNED_ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    reports, failures = [], 0
    try:
        for a in archs:
            for s in shapes:
                try:
                    rep = run_one(a, s, multi_pod=args.multi_pod,
                                  ctx_overrides=overrides,
                                  microbatches=args.microbatches)
                except Exception as e:  # noqa: BLE001 — report, go on
                    failures += 1
                    rep = {"arch": a, "shape": s,
                           "error": f"{type(e).__name__}: {e}"}
                    print(json.dumps(rep, default=str), file=sys.stderr)
                reports.append(rep)
                if args.json:
                    with open(args.json, "a") as f:
                        f.write(json.dumps(rep, default=float) + "\n")
    finally:
        close()
    ok = sum(1 for r in reports if not r.get("error"))
    print(f"\ndryrun: {ok}/{len(reports)} ran ({failures} failures)",
          file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
