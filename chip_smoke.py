"""Smoke run of the PyTorch/CUDA port on one card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line) if it
fails:

1. card: its name and power limit;
2. build: the CUDA kernels from the sources in this checkout, with ptxas's
   register / shared-memory / spill lines;
3. kernels: each kernel against its plain PyTorch version on the card at the
   serving path's shapes and more (head_dim 64/128/256, windows, ragged
   tiles and ragged valid lengths, one long shape), bf16 and f32, with the
   kernel's time, the plain version's, one PyTorch library call's
   (scaled_dot_product_attention, a yardstick the port never calls) and the
   least time the card could take (the bound);
4. engine: full-width gemma-2b (bf16, random weights from a seed) served
   through `repro_torch.launch.serve`, with both kernels' launch counts
   read around the run; then reduced float32 gemma-2b and gemma3-12b
   engines (the latter decoding past its rolling window) on the card
   against the same engines on the CPU (plain versions): the same greedy
   tokens;
5. fleet: the `--policy perllm` edge-cloud fleet on the card.

`--profile` also traces the warm engine run with torch.profiler (device
time by kernel and the device's busy share of the wall time).

Before the last line it prints one JSON object with a row per kernel; the
last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM memory rate
PEAK_OPS_PER_S = {"bfloat16": 989e12,   # dense tensor-core rate
                  "float32": 67e12}     # float32 outside the tensor cores
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
REL_RMS = 0.05                     # max error / RMS of the plain output
SERVE_ARGS = ["--arch", "gemma-2b", "--requests", "8", "--max-new", "16",
              "--max-batch", "4", "--max-seq", "256", "--device", "cuda"]
FLEET_ARGS = ["--policy", "perllm", "--requests", "12", "--max-new", "4",
              "--device", "cuda"]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", flush=True)
    sys.exit(1)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_ops: float, dtype: str):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                      else "operations")


def visible_pairs(sq, sk, window, q_offset) -> int:
    """(query, key) pairs the causal / window mask lets through."""
    n = 0
    for i in range(sq):
        qpos = i + q_offset
        hi = min(sk - 1, qpos)
        lo = max(0, qpos - window + 1) if window > 0 else 0
        n += max(0, hi - lo + 1)
    return n


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def sdpa(q, k, v, mask, scale):
    """One `scaled_dot_product_attention` call on the same inputs, GQA by
    `enable_gqa`. `mask=None` means plain causal attention: `is_causal`
    then leaves PyTorch free to pick its fastest (flash) backend."""
    import torch.nn.functional as F
    if mask is None:
        return lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale, enable_gqa=True)
    return lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=scale, enable_gqa=True)


def close(out, plain, dtype):
    """Max abs error, its share of the plain output's RMS, and whether both
    hold: allclose at the stated tolerance, and an error under REL_RMS of
    the RMS (at long shapes |out| is about the bf16 tolerance, so a
    dropped tile would pass allclose alone)."""
    import torch
    out, plain = out.float(), plain.float()
    err = (out - plain).abs().max().item()
    rel = err / max(plain.pow(2).mean().sqrt().item(), 1e-30)
    ok = torch.allclose(out, plain, rtol=TOL[dtype], atol=TOL[dtype]) \
        and rel <= REL_RMS
    return err, rel, ok


def check_flash(case, dev):
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    b, hq, hkv, sq, sk, d, window, q_offset, dtype, label = case
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(b, hq, sq, d, generator=gen, device=dev).to(dt)
    k = torch.randn(b, hkv, sk, d, generator=gen, device=dev).to(dt)
    v = torch.randn(b, hkv, sk, d, generator=gen, device=dev).to(dt)
    scale = d ** -0.5
    out = flash_attention(q, k, v, window=window, q_offset=q_offset,
                          scale=scale)
    torch.cuda.synchronize()
    plain = ref.flash_attention_ref(q, k, v, window=window, q_offset=q_offset,
                                    scale=scale)
    err, rel, ok = close(out, plain, dtype)
    mask = None
    if window > 0 or q_offset > 0 or sq != sk:
        qi = torch.arange(sq, device=dev)[:, None] + q_offset
        kj = torch.arange(sk, device=dev)[None, :]
        mask = kj <= qi
        if window > 0:
            mask = mask & (kj > qi - window)
    elem = q.element_size()
    n_bytes = elem * (2 * b * hq * sq * d + 2 * b * hkv * sk * d)
    n_ops = 4.0 * d * b * hq * visible_pairs(sq, sk, window, q_offset)
    bms, by = bound_ms(n_bytes, n_ops, dtype)
    return dict(
        kernel="flash_attention", label=label, shape=dict(
            b=b, hq=hq, hkv=hkv, sq=sq, sk=sk, d=d, window=window,
            q_offset=q_offset), dtype=dtype, max_abs_err=err, err_rms=rel,
        ok=ok,
        ms=time_ms(lambda: flash_attention(q, k, v, window=window,
                                           q_offset=q_offset, scale=scale)),
        plain_ms=time_ms(lambda: ref.flash_attention_ref(
            q, k, v, window=window, q_offset=q_offset, scale=scale)),
        library_ms=time_ms(sdpa(q, k, v, mask, scale)),
        bound_ms=bms, bound_by=by)


def check_decode(case, dev):
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    hq, hkv, s, d, valid, dtype, label = case
    b = len(valid)
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn(b, hq, d, generator=gen, device=dev).to(dt)
    k = torch.randn(b, hkv, s, d, generator=gen, device=dev).to(dt)
    v = torch.randn(b, hkv, s, d, generator=gen, device=dev).to(dt)
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    scale = d ** -0.5
    out = decode_attention(q, k, v, vl, scale=scale)
    torch.cuda.synchronize()
    plain = ref.decode_attention_ref(q, k, v, vl, scale=scale)
    err, rel, ok = close(out, plain, dtype)
    mask = (torch.arange(s, device=dev)[None, :] < vl[:, None])[:, None, None]
    q4 = q[:, :, None]
    slots = sum(min(x, s) if x > 0 else s for x in valid)  # slots read
    elem = q.element_size()
    n_bytes = elem * (2 * b * hq * d + 2 * hkv * slots * d) + 4 * b
    n_ops = 4.0 * d * hq * slots
    bms, by = bound_ms(n_bytes, n_ops, dtype)
    return dict(
        kernel="decode_attention", label=label, shape=dict(
            b=b, hq=hq, hkv=hkv, s=s, d=d, valid_len=list(valid)),
        dtype=dtype, max_abs_err=err, err_rms=rel, ok=ok,
        ms=time_ms(lambda: decode_attention(q, k, v, vl, scale=scale)),
        plain_ms=time_ms(lambda: ref.decode_attention_ref(q, k, v, vl,
                                                          scale=scale)),
        library_ms=time_ms(sdpa(q4, k, v, mask, scale)),
        bound_ms=bms, bound_by=by)


# (b, hq, hkv, sq, sk, d, window, q_offset, dtype, label)
FLASH_CASES = [
    (1, 8, 1, 32, 32, 256, 0, 0, "bfloat16", "path: gemma-2b prefill, bucket 32"),
    (1, 8, 1, 8, 8, 256, 0, 0, "bfloat16", "path: gemma-2b prefill, bucket 8"),
    (1, 8, 1, 32, 32, 256, 0, 0, "float32", "gemma-2b heads, f32"),
    # the fleet's engines are bf16 gemma-2b / gemma3-12b at d_model 64 / 128:
    # 2 q-heads on 1 kv-head, D = 64, prompt buckets 4, 8 and 16
    (1, 2, 1, 4, 4, 64, 0, 0, "bfloat16", "path: fleet prefill, bucket 4"),
    (1, 2, 1, 8, 8, 64, 0, 0, "bfloat16", "path: fleet prefill, bucket 8"),
    (1, 2, 1, 16, 16, 64, 0, 0, "bfloat16", "path: fleet prefill, bucket 16"),
    (1, 2, 1, 16, 16, 64, 64, 0, "bfloat16", "path: fleet cloud local prefill"),
    (1, 2, 1, 16, 16, 64, 0, 0, "float32", "fleet heads, f32"),
    (2, 16, 8, 40, 40, 256, 16, 0, "bfloat16", "gemma3 GQA, window, ragged"),
    (2, 32, 4, 128, 128, 128, 0, 0, "bfloat16", "yi-6b heads"),
    (1, 4, 4, 33, 50, 64, 0, 17, "float32", "q_offset, ragged tiles"),
    (1, 4, 2, 96, 96, 64, 64, 0, "float32", "window 64"),
    (1, 8, 1, 2048, 2048, 256, 0, 0, "bfloat16", "long: gemma-2b heads"),
]
# (hq, hkv, s, d, valid_len per row, dtype, label)
DECODE_CASES = [
    (8, 1, 256, 256, [20, 27, 33, 41], "bfloat16", "path: gemma-2b decode"),
    (8, 1, 256, 256, [20, 27, 33, 41], "float32", "gemma-2b heads, f32"),
    (2, 1, 64, 64, [5, 12], "bfloat16", "path: fleet edge decode"),
    (2, 1, 64, 64, [5, 12, 40, 64], "bfloat16", "path: fleet cloud decode"),
    (2, 1, 64, 64, [5, 12], "float32", "fleet heads, f32"),
    (16, 8, 128, 256, [0, 128, 3, 64], "bfloat16", "gemma3 GQA, valid 0"),
    (32, 4, 100, 128, [100, 50, 1, 7], "float32", "yi-6b heads, ragged"),
    (4, 4, 64, 64, [64, 64, 64, 64], "bfloat16", "MHA, full"),
    (8, 1, 4096, 256, [4096] * 32, "bfloat16", "long: gemma-2b B=32 S=4096"),
]


# ---------------------------------------------------------------------------
# phases 4 and 5: the port's main path
# ---------------------------------------------------------------------------


# arch: (reduced widths, max_seq, prompt lengths, new tokens). gemma3-12b's
# local layers keep a rolling cache of 64 slots: its 70-token prompt is
# prefilled into the last 64 slots and every request decodes past the window.
SMALL_ENGINES = {
    "gemma-2b": (dict(n_layers=2, d_model=256, vocab_size=512), 64,
                 [3, 7, 11, 15, 19], 8),
    "gemma3-12b": (dict(n_layers=2, d_model=128, vocab_size=512), 128,
                   [45, 52, 60, 70], 24),
}


def small_engine_tokens(arch: str, device: str):
    """Greedy tokens of a reduced float32 engine: on the card it runs the
    kernels, on the CPU their plain versions."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import ServingEngine
    widths, max_seq, lengths, new = SMALL_ENGINES[arch]
    cfg = dataclasses.replace(get_config(arch).reduced(**widths),
                              dtype="float32")
    params = init_params(cfg, seed=0, device="cpu")
    params = {k: _to(v, device) for k, v in params.items()}
    eng = ServingEngine(cfg, params, max_batch=3, max_seq=max_seq,
                        device=device)
    for i, n in enumerate(lengths):
        eng.submit([(7 * i + j) % cfg.vocab_size for j in range(n)],
                   max_new_tokens=new)
    return [r.generated for r in sorted(eng.run_until_idle(),
                                        key=lambda r: r.rid)]


def warm_engine_run(eng, prompts, profile: bool) -> dict:
    """The same prompts again on the warm engine, timed on the host clock
    around work that ends in a synchronise. With `profile`, the run is
    traced with torch.profiler and the device time by kernel printed."""
    import torch
    n0 = len(eng.completed)
    for p in prompts:
        eng.submit(p, max_new_tokens=16)
    prof = None
    if profile:
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = 0
    while eng.queue or eng.active_slots:
        eng.step()
        steps += 1
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
        table = prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=25)
        print(table)
        busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA)
        print(f"device busy {busy_us / 1e3:.1f} ms of {secs * 1e3:.1f} ms "
              f"wall ({100 * busy_us / 1e6 / secs:.1f}%)")
    toks = sum(len(r.generated) for r in eng.completed[n0:])
    if len(eng.completed) - n0 != len(prompts):
        fail("the warm engine run did not finish every request")
    return dict(tokens=toks, seconds=secs, steps=steps,
                tok_per_s=toks / secs, ms_per_step=1e3 * secs / steps)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def main(argv=None) -> None:
    profile = "--profile" in (sys.argv[1:] if argv is None else argv)
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             f"a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, ops
    from repro_torch.launch import serve
    from repro_torch.models import forward

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.time()

    # 1. card
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card_line = smi.stdout.strip().splitlines()[0]
    print(f"card: {name}, {torch.cuda.device_count()} device(s), torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    print(card_line, flush=True)

    # 2. build
    t0 = time.time()
    lib_path, log = _build.build()
    build_s = time.time() - t0
    print(f"build: {lib_path.name} in {build_s:.1f} s")
    for line in log.splitlines():
        if "ptxas info" in line and ("Used" in line or "spill" in line) \
                or "bytes stack frame" in line:
            print("  " + line.strip())
    _build.load_library()

    # 3. kernels against their plain versions
    rows = []
    for case in FLASH_CASES:
        rows.append(check_flash(case, dev))
    for case in DECODE_CASES:
        rows.append(check_decode(case, dev))
    for r in rows:
        print(f"{r['kernel']:16s} {r['dtype']:8s} {r['label']:36s} "
              f"err={r['max_abs_err']:.3e} ({100 * r['err_rms']:.2f}% rms) "
              f"ms={r['ms']:.4f} "
              f"plain_ms={r['plain_ms']:.4f} sdpa_ms={r['library_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']}) "
              f"{'ok' if r['ok'] else 'MISMATCH'}", flush=True)
    bad = [r for r in rows if not r["ok"]]
    if bad:
        fail(f"{len(bad)} kernel check(s) disagree with the plain version: "
             + "; ".join(f"{r['kernel']} {r['label']} {r['dtype']} "
                         f"err={r['max_abs_err']:.3e}" for r in bad))

    # 4. full-width gemma-2b engine through the launcher
    ops.reset_launches()
    eng, done, secs = serve.main(SERVE_ARGS)
    engine_launches = ops.kernel_launches()
    n_layers = eng.cfg.n_layers
    toks = sum(len(r.generated) for r in done)
    print(f"engine: {len(done)} requests, {toks} tokens, {secs:.2f} s, "
          f"{toks / secs:.1f} tok/s on {name}; launches {engine_launches}, "
          f"prefills {eng.n_prefills}, layers {n_layers}", flush=True)
    if len(done) != 8 or any(len(r.generated) != 16 for r in done):
        fail("the engine did not finish every request")
    vocab = eng.cfg.vocab_size
    if any(not 0 <= t < vocab for r in done for t in r.generated):
        fail("the engine produced tokens outside the vocabulary")
    if engine_launches["flash_attention"] != eng.n_prefills * n_layers:
        fail("prefill did not run the flash kernel once per layer")
    if engine_launches["decode_attention"] <= 0:
        fail("decode did not run the decode kernel")
    probe = torch.tensor([done[0].prompt], device=dev)
    logits, _ = forward(eng.params, {"tokens": probe}, cfg=eng.cfg,
                        mode="train")
    if logits.shape != (1, probe.shape[1], vocab) \
            or not bool(torch.isfinite(logits).all()):
        fail("full-width logits are not finite or of the wrong shape")
    warm = warm_engine_run(eng, [r.prompt for r in done], profile)
    print(f"engine, warm: {warm['tokens']} tokens in {warm['seconds']:.3f} s "
          f"({warm['tok_per_s']:.1f} tok/s), {warm['steps']} steps, "
          f"{warm['ms_per_step']:.2f} ms/step on {name}", flush=True)
    del eng, done, logits
    torch.cuda.empty_cache()

    for arch in SMALL_ENGINES:
        ops.reset_launches()
        on_card = small_engine_tokens(arch, "cuda")
        launches = ops.kernel_launches()
        on_cpu = small_engine_tokens(arch, "cpu")
        print(f"reduced f32 {arch} engine, card vs CPU plain path: "
              f"{'same' if on_card == on_cpu else 'DIFFERENT'} greedy "
              f"tokens; launches on the card {launches}", flush=True)
        if on_card != on_cpu:
            fail(f"{arch}: greedy tokens differ: card {on_card} "
                 f"cpu {on_cpu}")
        if min(launches.values()) <= 0:
            fail(f"{arch}: the reduced engine did not run both kernels")

    # 5. the PerLLM fleet
    ops.reset_launches()
    srv = serve.main(FLEET_ARGS)
    fleet_launches = ops.kernel_launches()
    served = srv.stats["n_served"]
    print(f"fleet: served {served}, per_server "
          f"{srv.stats['per_server_served']}, launches {fleet_launches}",
          flush=True)
    if served != 12:
        fail(f"the fleet served {served} of 12 requests")
    if min(fleet_launches.values()) <= 0:
        fail("the fleet did not run both kernels")

    # result
    path_rows = {"flash_attention": rows[0], "decode_attention":
                 rows[len(FLASH_CASES)]}
    sources = {
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:80"),
        "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                             "src/repro/kernels/decode_attention.py:64"),
    }
    kernels = []
    for kname, r in path_rows.items():
        kernels.append({
            "name": kname, "route": "cuda", "source": sources[kname][0],
            "replaces": sources[kname][1],
            "launches": engine_launches[kname] + fleet_launches[kname],
            "launches_by_path": {"engine": engine_launches[kname],
                                 "fleet": fleet_launches[kname]},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"], "dtype": r["dtype"]})
    print(f"total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
