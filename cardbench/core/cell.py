"""One run of one cell: set-up, the traffic, the measurements, the check.

Set-up (``setup_s``, from the start of the process) makes the weights on
the device from the seed, builds the engine and warms every prompt bucket
the mix uses and the decode step at the engine's batch. Then the traffic
runs: lead-in, window, tail (`serve.drive`). Once the window has closed
the peak memory is read, the engine is freed and the reference judges a
sample of what it served (`check`). Every metric is read by its own reader
(``metrics/<name>.py``) from the run's record.
"""
from __future__ import annotations

import gc
import math
import sys

import numpy as np
import torch

from cardbench.core import check, energy, port, profile, registry, serve
from cardbench.core.weights import make_weights

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_forbidden() -> list:
    """Modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def log(msg: str) -> None:
    print(f"cardbench: {msg}", file=sys.stderr, flush=True)


class Prepared:
    """A cell's set-up: the weights, the engine and the set-up time."""

    def __init__(self, cell: registry.Cell, seed: int, device,
                 t_process: float):
        cfg = cell.config
        self.shape = registry.family(cfg).shape(cfg)
        self.weights = make_weights(self.shape, seed, device)
        self.engine = port.engine(cfg, self.weights, device)
        serve.warm_up(self.engine, cell.traffic, self.shape.vocab)
        _sync(device)
        self.setup_s = serve.clock() - t_process
        self.record = None           # the last `measure`'s record
        self.gaps = None             # and its gaps (program, control)
        log(f"set-up {self.setup_s:.3f} s")


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(cell: registry.Cell, *, seed: int, seconds: float, trace: bool,
        device, t_process: float, bench_dir=registry.BENCH_DIR) -> dict:
    """One run of the benchmark: set-up, then `measure`."""
    return measure(cell, Prepared(cell, seed, device, t_process), seed=seed,
                   seconds=seconds, trace=trace, device=device,
                   bench_dir=bench_dir)


def measure(cell: registry.Cell, prep: Prepared, *, seed: int,
            seconds: float, trace: bool, device,
            bench_dir=registry.BENCH_DIR, rate: float | None = None,
            judge: bool = True, control: bool = False) -> dict:
    """The traffic on the prepared engine, the metrics and the check. The
    engine is used up. `rate` replaces the cell's offered rate, `judge`
    False skips the check, `control` adds the fp8 control's reading of the
    same sample (the calibration tools' options; a run of the benchmark
    takes none)."""
    cfg, mix, st = cell.config, cell.traffic, cell.settings
    cuda = torch.device(device).type == "cuda"
    shape, weights, engine = prep.shape, prep.weights, prep.engine
    prep.engine = None

    def sync():
        _sync(device)

    meter = energy.Meter() if cuda else None
    source = serve.Source(mix, seed, shape.vocab, seconds,
                          rate if rate is not None else st.get("rate_per_s"))
    # the traced span: the last profile_s seconds of the window (half the
    # window at most)
    span = min(st["profile_s"], seconds / 2)
    if trace:
        serve.warm_profiler(sync)
    served, steps, window, end, joules, prof = serve.drive(
        engine, source, lead_in=mix["lead_in_s"], seconds=seconds,
        tail=mix["tail_s"], meter=meter,
        profile_at=seconds - span if trace else None, sync=sync)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    found = loaded_forbidden()
    if found:
        raise SystemExit(f"cardbench: the run loaded {found}; the benchmark "
                         f"runs the port alone")
    tr = profile.reduce(profile.kineto_events(prof)) if prof else None
    del prof
    rec = serve.Record(shape=shape, window=window, end=end, steps=steps,
                       requests=served, setup_s=prep.setup_s,
                       energy_j=joules, trace=tr)
    prep.record = rec

    # the check, once the program's state is freed
    finished = [r for r in served if not math.isnan(r.done)]
    wrong = [r for r in finished if len(r.tokens) != r.item.max_new]
    bad = {id(r) for r in wrong}
    pick = check.sample([r for r in finished if r.done >= window[0]], seed,
                        st["sample_tokens"])
    pairs = [(r.prompt, r.tokens) for r in pick]
    del engine
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    g = np.zeros(0)
    if judge:
        ref = check.reference_logits(weights, cfg, pairs, device)
        g = check.gaps(ref, pairs)
    lim = st["limits"]
    gap = {"max_logit_gap": float(g.max()) if g.size else 1e30,
           "mean_logit_gap": float(g.mean()) if g.size else 1e30}
    checks = {k: {"value": v, "limit": lim[k]} for k, v in gap.items()
              if k in lim}
    checks["wrong_token_counts"] = {"value": len(wrong), "limit": 0}
    checks["compared_tokens"] = {"value": int(g.size),
                                 "limit": lim["min_compared_tokens"],
                                 "min": True}
    correct = check.judge(checks)
    control_gap = None
    prep.gaps = (g, None)
    if judge and control:
        low = check.reference_logits(weights, cfg, pairs, device, "fp8")
        cg = check.gap_of_argmax(ref, low)
        control_gap = {"max_logit_gap": float(cg.max()),
                       "mean_logit_gap": float(cg.mean())}
        prep.gaps = (g, cg)
        del low
    if judge:
        del ref

    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        v = registry.reader(m["name"], bench_dir)(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    due = rec.due_in_window()
    late = [r.submitted - r.due for r in due if not math.isnan(r.submitted)]
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if tr is not None:
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
    out = {"correct": bool(correct), "attempted": len(due),
           "failed": sum(1 for r in due if id(r) in bad),
           "metrics": metrics, "device": dev}
    if tr is not None:
        out["breakdown"] = tr.breakdown
    out["info"] = {
        "seed": seed, "window_s": rec.window_s, "steps": len(
            rec.window_steps()),
        "completed_in_window": sum(1 for r in served
                                   if rec.in_window(r.done)),
        "submit_late_ms_p95": float(np.percentile(late, 95)) * 1e3
        if late else None,
        "submit_late_ms_max": max(late) * 1e3 if late else None,
        "energy_source": meter.source if meter and meter.lib else None,
        "power_limit_w": meter.power_limit_w() if meter and meter.lib
        else None,
        "sample_requests": len(pick),
        "gaps": gap,
        "ttft_ms": _quantiles([((r.stamps[0] if r.stamps else end) - r.due)
                               * 1e3 for r in due]),
        "decode_step_ms": _quantiles([(x.t1 - x.t0) * 1e3
                                      for x in rec.host_steps()
                                      if not x.prefills]),
        "step_ms": _quantiles([(x.t1 - x.t0) * 1e3
                               for x in rec.host_steps()]),
        "kv_in_use_gib": _kv_in_use_gib(rec),
        "out_tok_s_halves": _halves(rec),
    }
    if control_gap is not None:
        out["info"]["control_gaps"] = control_gap
    out["checks"] = {k: {"value": v["value"], "limit": v["limit"]}
                     for k, v in checks.items()}
    for k, v in checks.items():
        op = ">=" if v.get("min") else "<="
        log(f"check {k} {v['value']} (limit {op} {v['limit']})")
    return out


def _kv_in_use_gib(rec) -> dict | None:
    """The keys and values the traffic holds in the window's steps: every
    request a step decoded, at the positions it attended, in GiB (mean and
    most over the steps), and the requests in flight a step."""
    per_token = rec.shape.kv_bytes_per_token
    held = [sum(x.decode_keys) * per_token / 2**30
            for x in rec.window_steps()]
    if not held:
        return None
    return {"mean": float(np.mean(held)), "max": max(held),
            "active_mean": float(np.mean([len(x.decode_keys)
                                          for x in rec.window_steps()]))}


def _halves(rec) -> list:
    """Output tokens a second in each half of the window: how far a run's
    rate moves within it, beside how far runs move apart."""
    t0, t1 = rec.window
    mid = (t0 + t1) / 2
    return [sum(1 for r in rec.requests for t in r.stamps if a < t <= b)
            / (b - a) for a, b in ((t0, mid), (mid, t1))]


def _quantiles(v: list) -> dict | None:
    if not v:
        return None
    q = np.percentile(v, [50, 90, 95, 99])
    return {"n": len(v), "p50": q[0], "p90": q[1], "p95": q[2], "p99": q[3],
            "max": max(v)}
