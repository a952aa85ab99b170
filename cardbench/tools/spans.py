"""The engine's phases on the card: a cell's traffic with the engine's span
log on (``repro_torch.obs.spans``), read span by span.

    python3 cardbench/tools/spans.py --workload <name> --seed <n> \
        --seconds <s> [--off] [--out <file.jsonl>]

One run as ``run.py --trace 1`` makes it (set-up, lead-in, the window with
the profiler over its last seconds, tail; no check), with a span log on the
engine (``--off``: none, to read what recording costs). One JSON line:
- ``metrics``: the cell's per-layer metrics, each read by its own reader,
  from the trace less the device-side twins of the program's ranges;
- ``spans``: the span log over the window before the profiler starts: the
  median ``engine.prefill``, ``engine.decode``, ``engine.cache`` and
  ``engine.insert`` ms, the token reads' share of the steps' host time, the bucket padding's share of the
  positions prefilled, spans a step; and the counters' growth over the
  traffic;
- ``by_range``: the traced span's device idle time by the innermost
  ``engine.*`` range the host was in (``outside engine.step`` where none);
  the device seconds of the operations by the innermost ``engine.*`` or
  ``model.*`` range open where they were launched (the profiler's links
  from an operation to its launch); the idle share inside
  ``engine.prefill``, the prefills' share of the linked device time and
  the head's share of busy time;
- ``ranges_left_in``: what ``profile.reduce`` reads with those twins left
  in the trace (busy time, the top device operations);
- ``host``: the steps' host ms before the profiler starts (all steps, and
  those that admitted no prompt), what one span and one site left off
  cost on this host before the traffic (no profiler recording), and the
  spans' share of a median step at that cost.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import collections  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[2]
COUNTERS = ("engine.prefill_positions", "engine.prefill_pad_positions")


def split_twins(events: list) -> tuple:
    """The profiler's events less the device-side twins of the program's
    ranges, and those twins."""
    from cardbench.core.ranges import PROGRAM_RANGES
    kept, twins = [], []
    for e in events:
        (twins if e.on_device and e.name.startswith(PROGRAM_RANGES)
         else kept).append(e)
    return kept, twins


def linked_events(prof) -> tuple:
    """The profiler's events (as `profile.kineto_events` gives them), and
    for each device operation the profiler links to what launched it, the
    host start of that launch: {(name, start_ns, end_ns): host ns}. A
    device operation's correlation id names its launch call (CUPTI's);
    failing that, its linked id names the host operation open at its
    launch."""
    from cardbench.core.profile import Event
    events, device, op_at, call_at = [], [], {}, {}
    for k in prof.profiler.kineto_results.events():
        start = k.start_ns()
        e = Event(k.name(), start, start + k.duration_ns(),
                  str(k.device_type()).endswith("CUDA"))
        events.append(e)
        if e.on_device:
            device.append((e, k.linked_correlation_id(), k.correlation_id()))
        elif e.name.startswith("cu"):
            call_at[k.correlation_id()] = start
        else:
            op_at[k.correlation_id()] = start
    launch = {}
    for e, linked, corr in device:
        t = call_at.get(corr) if corr > 0 else None
        if t is None and linked > 0:
            t = op_at.get(linked)
        if t is not None:
            launch[(e.name, e.start_ns, e.end_ns)] = t
    return events, launch


def by_range(events: list, trace, launch: dict) -> dict:
    """The traced span's idle time by the innermost host ``engine.*`` range
    open at each gap's middle; the device seconds of each operation by the
    innermost ``engine.*`` or ``model.*`` range open at its launch
    (`linked_events`), and of those launched inside ``engine.prefill``."""
    from cardbench.core import ranges
    host = [(e.name, e.start_ns, e.end_ns) for e in events
            if not e.on_device and e.name.startswith(ranges.PROGRAM_RANGES)]
    engine = [r for r in host if r[0].startswith("engine.")]
    starts, pieces = ranges.innermost(engine)
    gaps = ranges.idle_gaps(trace)
    idle = collections.Counter()
    for a, b in gaps:
        idle[ranges.label_at(starts, pieces, (a + b) // 2,
                             "outside engine.step")] += b - a
    prefill = ranges.union((s, e) for n, s, e in engine
                           if n == "engine.prefill")
    pre_starts = [s for s, _ in prefill]
    starts, pieces = ranges.innermost(host)
    dev = collections.Counter()
    in_prefill = unlinked = 0
    for n, s, e in trace.device_ops:
        t = launch.get((n, s, e))
        if t is None:
            unlinked += e - s
            continue
        dev[ranges.label_at(starts, pieces, t, "outside engine.step")] += \
            e - s
        k = bisect.bisect_right(pre_starts, t) - 1
        if k >= 0 and t < prefill[k][1]:
            in_prefill += e - s
    total = sum(b - a for a, b in gaps)
    busy_ns = trace.busy_s * 1e9
    linked = sum(dev.values())
    return {
        "idle_by_range": [[n, t / 1e9] for n, t in idle.most_common()],
        "device_by_range": [[n, t / 1e9] for n, t in dev.most_common()],
        "device_unlinked_s": unlinked / 1e9,
        "idle_in_prefill": 100.0 * ranges.overlap(gaps, prefill) / total
        if total else None,
        "device_in_prefill": 100.0 * in_prefill / linked if linked else None,
        "head_share": 100.0 * dev["model.head"] / busy_ns
        if busy_ns else None,
    }


def span_readings(spans: list, rec, counters: dict) -> dict:
    """The span log's readings over `rec.host_window`."""
    t0, t1 = (x * 1e9 for x in rec.host_window)
    inside = [s for s in spans if s.t0_ns >= t0 and s.t1_ns <= t1]

    def median_ms(name):
        ms = [s.dur_ns / 1e6 for s in inside if s.name == name]
        return statistics.median(ms) if ms else None

    def total(name):
        return sum(s.dur_ns for s in inside if s.name == name)

    steps = sum(1 for s in inside if s.name == "engine.step")
    pre = [s.attrs for s in inside
           if s.name == "engine.prefill" and s.attrs["bucket"]]
    positions = sum(a["bucket"] for a in pre)
    return {
        "prefill_ms": median_ms("engine.prefill"),
        "decode_dispatch_ms": median_ms("engine.decode"),
        "cache_ms": median_ms("engine.cache"),
        "insert_ms": median_ms("engine.insert"),
        "host_wait_share": 100.0 * total("engine.sync") / total("engine.step")
        if steps else None,
        "pad_share": 100.0 * sum(a["bucket"] - a["tokens"] for a in pre)
        / positions if positions else None,
        "prefills": len(pre), "steps": steps,
        "spans_per_step": len(inside) / steps if steps else None,
        "counters": counters,
    }


def host_costs_us(n: int = 20000) -> dict:
    """Host µs, with no profiler recording, of one empty span of a span log
    (`span`) and of one site whose span or range is off (`site_off`: a
    model range outside a recorded step)."""
    from repro_torch.obs.spans import SpanLog, model_range
    log = SpanLog()
    out = {}
    for key, enter in (("span", lambda: log.span("engine.cost")),
                       ("site_off", lambda: model_range("model.norm"))):
        t = time.perf_counter()
        for _ in range(n):
            with enter():
                pass
        out[key] = (time.perf_counter() - t) / n * 1e6
    return out


def run(cell, *, seed: int, seconds: float, device, spans_on: bool = True,
        t_process: float | None = None) -> dict:
    """One run of `cell` with (or without) the engine's span log; the
    readings above."""
    import torch

    from cardbench.core import cell as C
    from cardbench.core import profile, registry, serve
    from repro_torch.obs.spans import SpanLog
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    prep = C.Prepared(cell, seed, device,
                      time.perf_counter() if t_process is None else t_process)
    engine, prep.engine = prep.engine, None
    log = SpanLog() if spans_on else None
    engine.spans = log
    before = {k: engine.metrics.get(k) for k in COUNTERS}
    cost = host_costs_us()
    mix, st = cell.traffic, cell.settings
    source = serve.Source(mix, seed, prep.shape.vocab, seconds,
                          st.get("rate_per_s"))
    span = min(st["profile_s"], seconds / 2)
    serve.warm_profiler(sync)
    served, steps, window, end, _, prof = serve.drive(
        engine, source, lead_in=mix["lead_in_s"], seconds=seconds,
        tail=mix["tail_s"], profile_at=seconds - span, sync=sync)
    counters = {k: engine.metrics.get(k) - before[k] for k in COUNTERS}
    events, launch = linked_events(prof)
    del prof, engine
    kept, twins = split_twins(events)
    tr = profile.reduce(kept)
    rec = serve.Record(shape=prep.shape, window=window, end=end, steps=steps,
                       requests=served, setup_s=prep.setup_s, trace=tr)
    left_in = profile.reduce(events) if twins else tr
    host = rec.host_steps()
    out = {
        "workload": cell.name, "seed": seed, "spans_on": spans_on,
        "device": torch.cuda.get_device_name(0) if cuda else "cpu",
        "metrics": {m["name"]: registry.reader(m["name"])(rec)
                    for m in cell.per_layer},
        "spans": span_readings(log.spans, rec, counters) if log else None,
        "by_range": by_range(events, tr, launch),
        "ranges_left_in": {
            "twins": len(twins), "busy_s": left_in.busy_s,
            "busy_s_without": tr.busy_s, "window_s": tr.window_s,
            "device_ops": left_in.breakdown["device_ops"][:5]},
        "host": {
            "step_ms": C._quantiles([(s.t1 - s.t0) * 1e3 for s in host]),
            "decode_step_ms": C._quantiles([(s.t1 - s.t0) * 1e3
                                            for s in host if not s.prefills]),
            "cost_us": cost},
        "breakdown": tr.breakdown,
    }
    sp = out["spans"]
    med = out["host"]["step_ms"]
    if sp and sp["spans_per_step"] and med:
        out["host"]["recording_share_est"] = \
            100.0 * sp["spans_per_step"] * cost["span"] / (med["p50"] * 1e3)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=50.0)
    ap.add_argument("--off", action="store_true",
                    help="no span log: the same run unrecorded")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from cardbench.core import registry
    if not torch.cuda.is_available():
        print("spans: no CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    out = run(registry.cell(args.workload), seed=args.seed,
              seconds=args.seconds, device="cuda", spans_on=not args.off,
              t_process=T_PROCESS)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
