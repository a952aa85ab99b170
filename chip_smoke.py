"""Smoke run of the PyTorch/CUDA port on one card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line) if it
fails:

1. card: its name and power limit;
2. build: the four CUDA kernels from the sources in this checkout, with
   ptxas's register / shared-memory / spill lines;
3. kernels: the bf16 flash kernel's one-tile tensor-core self-test at each
   head_dim (wgmma, swizzle and descriptors against plain matrix
   products); then each kernel against its plain PyTorch version on the
   card at the serving path's shapes and more (head_dims, windows, ragged
   tiles and ragged valid lengths, shuffled page tables, long shapes), bf16
   and f32, with the kernel's time by the event loop (`ms`, the wrapper's
   host cost included) and its device time a call by torch.profiler over
   the same loop (`device_us`), the plain version's time, one PyTorch
   library call's where one computes the same function
   (scaled_dot_product_attention, a yardstick the port never calls) and
   the least time the card could take (the bound); the long paged rows
   also give the decode kernel's device time on the same slots laid out
   densely (`dense_decode_us`, a yardstick, not a gate);
4. engine: full-width gemma-2b (bf16, random weights from a seed) served
   through `repro_torch.launch.serve`, with the kernels' launch counts
   read around the run; then reduced float32 gemma-2b, gemma3-12b (decoding
   past its rolling window), mamba2, deepseek-moe-16b, mixtral-8x7b (past
   its rolling window), minicpm3-4b, recurrentgemma-2b, qwen2-vl-2b and
   the deployments' llama2-7b, llama3-8b, llama2-33b and gemma3-27b
   engines on the card against the same engines on the CPU (plain
   versions): the same greedy tokens;
5. mamba2: full-width mamba2-2.7b (bf16) served through the launcher with
   prompts up to the 256 bucket, one SSD-diagonal launch per layer and
   prefill; then a reduced float32 paged mamba2 engine evicting and
   resuming a request (its SSM state through the snapshot), card against
   CPU and against the uninterrupted run, and the same for reduced paged
   gemma-2b and minicpm3-4b engines with a prefix hit;
6. paged: full-width gemma-2b through the launcher with `--paged` and a pool
   that stalls admission; a request evicted mid-decode and resumed with
   the dense engine's tokens, and the paged kernel launched on every
   layer's pool through its page table against the decode kernel on the
   slot's dense cache; a prompt hitting a shared prefix; and a reduced
   float32 paged engine with a prefix hit and an eviction, card against
   CPU;
7. fleet: the `--policy perllm` edge-cloud fleet on the card, dense and
   `--paged` (the paged one against the same fleet on the CPU), and the
   serving example (`repro_torch.examples.perllm_serving`, the JAX
   package's `examples/perllm_serving.py`) with its 24 requests on the
   card's engines;
8. moe / mla: full-width deepseek-moe-16b (dense dispatch), minicpm3-4b
   (MLA: prefill through the flash kernel at head_dim 96, decode through
   latent matrix products) dense and `--paged` with a prefix hit on the
   latent pages, and mixtral-8x7b at full width with its depth cut to 4
   layers (32 do not fit one card), bf16, each served through the
   launcher's engine and freed before the next; the reduced float32 engines
   of the three (and a paged minicpm3 one) are in phases 4 and 5;
9. rg-lru / m-rope: full-width recurrentgemma-2b (26 layers: 18 RG-LRU
   layers and 8 attention layers of 10 q-heads on 1 kv-head, window 2048),
   dense and `--paged` (a request evicted and resumed with the dense
   engine's tokens, the paged kernel at 10 q-heads a kv-head on every
   attention layer's pool), and qwen2-vl-2b (28 M-RoPE attention layers,
   12 q-heads on 2), bf16, served through the launcher and freed one after
   the other: flash once an attention layer a prefill, decode once an
   attention layer a decode step; the reduced float32 engines of both (and
   a paged recurrentgemma one) are in phases 4 and 5;
10. whisper / training: full-width whisper-base (6 encoder and 6 decoder
   layers, bf16) at the model level (no engine serves an encoder-decoder
   model): 4 requests of 4-23 tokens with 1500 random frames each,
   prefilled and then decoded 16 greedy steps together, the flash kernel
   non-causal in the encoder and the cross attention (18 launches a
   prefill, 6 a step) and the decode kernel 6 a step; a reduced float32
   whisper card against CPU; then full-width gemma-2b trained 4 steps
   through `repro_torch.launch.train` (batch 4 x 256 tokens, bf16; the
   step-0 loss near ln V, every loss and gradient norm finite, the
   parameters moved; ms a step, tokens a second, peak memory, 18 flash
   launches a step), one train step of full-width whisper-base, and three
   train steps (one and two microbatches) of a reduced float32 model of
   each family, card against CPU. Phase 3 also holds the non-causal
   flash rows at whisper's shapes, the kernel's logsumexp output and
   FlashAttentionFn's gradients at gemma-2b's training shape;
11. sharded: the single-rank references first (then freed), then 4 ranks
   spawned on the one card over gloo on a (2, 2) ("data", "model") mesh,
   each drawing the full weights from the seed a layer at a time and
   keeping its shard: full-width gemma-2b prefill and a scalar-position
   decode (its cache's sequence split over "model": the context-parallel
   decode, the decode kernel writing its logsumexp) and the sharded
   engine serving phase 4's requests (tok/s, host launches a step,
   per-rank peak memory); full-width deepseek-moe-16b cut to 6 layers
   with `ep_a2a` and the constraint form in bf16 (printed beside one
   rank's, with one rank's bf16 distance from float32 at two weight
   seeds), then in float32 the constraint form through the model and the
   `ep_a2a` layer alone, each within 0.1% of the RMS of one rank's dense
   dispatch; a sharded train step of full-width gemma-2b, its loss,
   gradient norm, update norm and last layer's weights and moments held
   to one rank's step by gates that a step on half the batch fails;
   gemma-2b's sharded paged engine (an eviction, a resume in the other
   data rank's slot, a prefix hit) against its dense sharded engine; the
   sharded engines of full-width mamba2-2.7b and minicpm3-4b (both cut to
   half their depth), recurrentgemma-2b and qwen2-vl-2b (the Mamba-2,
   RG-LRU and MLA mixers on the rank's heads or channels), each with its
   logits against one rank's, tok/s, host launches and collectives a
   decode step (no all-gather as large as a mixer weight), per-rank peak
   memory, and the paged kernel on a rank's qwen2-vl pools against its
   plain version; whisper-base at the
   model level; reduced float32 engines of gemma-2b, deepseek (constraint
   form) and the four families against one CPU process. bf16 logits are
   held to the float32 model (no further than 1.25x one rank's bf16 run);
   it prints the collectives by kind and bytes, and fails if gemma-2b's
   train step or CP path's prefill all-gathers float32 logits over every
   position (the vocabulary-parallel head and cross-entropy gather the
   returned rows alone). Every prefill and train step whose sequence the
   model axis divides splits the residual stream over it (sequence
   parallelism): it prints the train step's, the CP path's and each
   engine's peak a rank and all-gathers, reduce-scatters and all-reduces,
   and fails if the train step or the CP prefill reduce-scatters fewer
   than two residual partials a layer or all-reduces one as large as a
   whole (B_local, S, D) float32 partial. Phase 3 also holds the
   decode kernel's logsumexp, the CP decode body (each shard's decode,
   then the combine) and every kernel at the ranks' shapes against their
   plain versions;
12. deployments / examples: the paper's deployment models (yi-6b,
   llama2-7b, llama3-8b, yi-9b and the cloud's llama2-33b, 60.6 GiB of
   weights) and the gemma3 pair (gemma3-12b, gemma3-27b) at full width
   and depth, bf16, each served through the launcher's engine and freed
   before the next, held to phase 8's checks (every request done inside
   the vocabulary, flash once an attention layer a prefill, decode once an
   attention layer a step, a finite probe logit), with tok/s cold and
   warm, ms a step, host launches a traced decode step, the device's busy
   share and peak memory beside the card's name and power limit; gemma3
   with prompts of 600-1900 tokens into 2048 slots, past its 1024-slot
   window (the windowed flash kernel at 2048, the rolling decode); a paged
   gemma3-12b engine whose pool stalls admission, with an eviction resumed
   across slot 1024 with the dense engine's tokens and the paged kernel
   on its 8 global layers' pools; then the JAX package's last three
   examples on the card: `repro_torch.examples.arch_zoo` over the 10
   archs (each tour's launches counted), `quickstart` (train, serve,
   schedule) and `train_100m` for 200 steps (the loss falls, its
   checkpoint reads back bit for bit). Phase 3 also holds every kernel at
   these engines' shapes and phase 4 the reduced float32 llama2-7b,
   llama3-8b, llama2-33b and gemma3-27b engines, card against CPU.

`python3 chip_smoke.py --step-launches SRC ARCH...` is a measurement, not
the smoke: with `repro_torch` imported from SRC (a tree's `src`, so that two
trees compare in one call), it serves the launcher's 8 requests on each
full-width single-device ARCH engine (mixtral-8x7b cut to phase 8's 4
layers) twice, cold then warm, under torch.profiler, and prints a JSON line
an ARCH: the host's kernel launches divided by the traced decode steps.
`python3 chip_smoke.py --deploy-tokens SRC [ARCH...]` serves phase 12's
deployment engines (those of the ARCHs given, else all) from SRC's
`repro_torch`, cold and warm as phase 12 does, and prints a JSON line an
engine: its peak memory and a digest of its greedy tokens, so that two
trees' tokens and peaks compare in one call.

`--profile` also traces the warm engine runs of phases 4, 5, 8 and 9 (phase
12 traces a few decode steps of each engine whether or not it is given) and
one more full-width gemma-2b train step in phase 10 with torch.profiler
(device time by kernel and the device's busy share of the wall time; for
the train step also the device time of its gradient and AdamW halves).

Before the last line it prints one JSON object with a row per kernel; the
last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"                    # where every main path runs
HBM_BYTES_PER_S = 3.35e12          # H100 SXM memory rate
PEAK_OPS_PER_S = {"bfloat16": 989e12,   # dense tensor-core rate
                  "tf32": 494.7e12,     # dense TF32 tensor-core rate
                  "float32": 67e12}     # float32 outside the tensor cores
# the units a flash row's operations are counted at: float32 flash runs on
# the tensor cores in 3xTF32 (decode and paged rows keep the dtype's)
RATE = {"float32": "tf32", "bfloat16": "bfloat16"}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# the flash kernel's logsumexp against the plain one: bf16 scores come from
# the tensor cores and exp2 in hardware, to about 1e-5 of their size
LSE_TOL = {"float32": 2e-5, "bfloat16": 1e-3}
REL_RMS = 0.05                     # max error / RMS of the plain output
# the SSD kernel against the plain version on the CPU, summed in float64:
# max error / RMS read 3.3e-6 to 2.2e-4 on the H100 against a float32 CPU
# version (and once 1.16e-3), so 5x the usual most
CPU_REL_RMS = 1e-3
LIBRARY = {
    "flash_attention": "scaled_dot_product_attention (is_causal, or a "
                       "boolean mask for windows and offsets)",
    "decode_attention": "scaled_dot_product_attention with a boolean mask",
    "paged_attention": "none: no single PyTorch call reads a paged pool "
                       "through a page table",
    "ssd_diag": "none: no single PyTorch call computes the SSD diagonal "
                "block",
    "decode_attention_lse": "none: no public PyTorch call returns the "
                            "logsumexp beside a masked decode's output",
}
SERVE_ARGS = ["--arch", "gemma-2b", "--requests", "8", "--max-new", "16",
              "--max-batch", "4", "--max-seq", "256", "--device", "cuda"]
FLEET_ARGS = ["--policy", "perllm", "--requests", "12", "--max-new", "4",
              "--device", "cuda"]
# mamba2-2.7b at full width; prompts of 60-199 tokens fall in the 64, 128
# and 256 buckets, so prefill runs the SSD kernel at chunks 64, 128, 256
MAMBA_ARGS = ["--arch", "mamba2-2.7b", "--requests", "6", "--max-new", "8",
              "--max-batch", "4", "--max-seq", "512", "--prompt-len", "60",
              "200", "--device", "cuda"]
# gemma-2b with a 10-block pool: each request needs 2-3 blocks of 16
# tokens, so fewer than the 4 lanes fit and admission stalls
PAGED_ARGS = SERVE_ARGS + ["--paged", "10"]


def fail(msg: str) -> None:
    """Stop the run. The reason goes to both streams: a caller that keeps
    only the end of standard error still reads why."""
    print(f"chip_smoke: FAILED: {msg}", flush=True)
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
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


def _traced_rows(fns, rows, iters: int) -> dict:
    """One torch.profiler trace over `iters` calls of each function of
    `rows` (indices into `fns`), each row's loop inside a `record_function`
    range that ends after a synchronise. Returns each row's summed device
    time, 0 where the trace holds none of its kernels: every kernel that
    starts inside the row's range, or, where none does, the kernels the
    trace ties to the range's launches (the range's `device_time_total`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in rows:
            with record_function(f"chip_smoke_row_{i}"):
                for _ in range(iters):
                    fns[i]()
                torch.cuda.synchronize()
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    # the CPU ranges; each also has a device-side span of the same name,
    # which is no kernel
    ranges = {e.name: e for e in events
              if e.name.startswith("chip_smoke_row_") and e.device_type != cuda}
    kernels = [e.time_range for e in events if e.device_type == cuda
               and not e.name.startswith("chip_smoke_row_")]
    out = {}
    for i in rows:
        e = ranges.get(f"chip_smoke_row_{i}")
        if e is None:
            out[i] = 0.0
            continue
        r = e.time_range
        out[i] = sum(k.elapsed_us() for k in kernels
                     if r.start <= k.start <= r.end) or e.device_time_total
    return out


def device_us(fns, iters: int = 20, attempts: int = 3) -> list:
    """Device time a call, in µs, of each function in `fns`, after a
    warm-up: one trace for all the rows (`_traced_rows`). It leaves out the
    host time the event-loop `ms` includes. A trace now and then comes back
    without a row's kernels: those rows are traced again in a trace of
    their own, up to `attempts` traces in all. A row whose kernels no trace holds fails the
    run."""
    import torch
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    totals = {}
    todo = list(range(len(fns)))
    for attempt in range(attempts):
        got = _traced_rows(fns, todo, iters)
        totals.update({i: t for i, t in got.items() if t > 0})
        todo = [i for i in todo if i not in totals]
        if not todo:
            break
        print(f"device_us: trace {attempt + 1} held no device time for rows "
              f"{todo}", flush=True)
    if todo:
        fail(f"torch.profiler recorded no device time for rows {todo} in "
             f"{attempts} traces")
    return [totals[i] / iters for i in range(len(fns))]


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


def sdpa(q, k, v, mask, scale, causal: bool = True):
    """One `scaled_dot_product_attention` call on the same inputs, GQA by
    `enable_gqa`. `mask=None` means plain causal attention (or none where
    not `causal`): PyTorch is then free to pick its fastest (flash)
    backend."""
    import torch.nn.functional as F
    if mask is None:
        return lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, scale=scale, enable_gqa=True)
    return lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=scale, enable_gqa=True)


def close(out, plain, dtype):
    """Max abs error, its share of the plain output's RMS, and whether both
    hold: allclose at the stated tolerance, and an error under REL_RMS of
    the RMS (at long shapes |out| is about the bf16 tolerance, so a
    dropped tile would pass allclose alone). An all-zero plain output
    proves nothing and fails."""
    import torch
    out, plain = out.float(), plain.float()
    err = (out - plain).abs().max().item()
    rms = plain.pow(2).mean().sqrt().item()
    rel = err / max(rms, 1e-30)
    ok = torch.allclose(out, plain, rtol=TOL[dtype], atol=TOL[dtype]) \
        and rel <= REL_RMS and rms > 0
    return err, rel, ok


def flash_inputs(case, dev, seed=0):
    import torch
    b, hq, hkv, sq, sk, d, _, _, dtype, _ = case
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(b, h, s, d, generator=gen, device=dev).to(dt)
            for h, s in ((hq, sq), (hkv, sk), (hkv, sk))]


def flash_mask(sq, sk, window, q_offset, causal, dev):
    """The boolean mask SDPA needs, or None where `is_causal` (or no mask)
    says it."""
    import torch
    if not causal or (window == 0 and q_offset == 0 and sq == sk):
        return None
    qi = torch.arange(sq, device=dev)[:, None] + q_offset
    kj = torch.arange(sk, device=dev)[None, :]
    mask = kj <= qi
    if window > 0:
        mask = mask & (kj > qi - window)
    return mask


def check_flash(case, dev, causal: bool = True, lse: bool = False):
    """A flash row: the kernel (with `lse`, also its logsumexp output,
    held against the plain logsumexp) against the plain version."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    b, hq, hkv, sq, sk, d, window, q_offset, dtype, label = case
    q, k, v = flash_inputs(case, dev)
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              scale=d ** -0.5)
    got = flash_attention(q, k, v, return_lse=lse, **kw)
    torch.cuda.synchronize()
    plain_fn = ref.flash_attention_lse_ref if lse else ref.flash_attention_ref
    plain = plain_fn(q, k, v, **kw)
    extra = {}
    if lse:
        (got, got_lse), (plain, plain_lse) = got, plain
        lse_err = (got_lse - plain_lse).abs().max().item()
        tol = LSE_TOL[dtype]
        extra = dict(lse_err=lse_err, lse_ok=bool(torch.allclose(
            got_lse, plain_lse, rtol=tol, atol=tol)))
    err, rel, ok = close(got, plain, dtype)
    mask = flash_mask(sq, sk, window, q_offset, causal, dev)
    elem = q.element_size()
    n_bytes = elem * (2 * b * hq * sq * d + 2 * b * hkv * sk * d) \
        + (4 * b * hq * sq if lse else 0)
    pairs = visible_pairs(sq, sk, window, q_offset) if causal else sq * sk
    n_ops = 4.0 * d * b * hq * pairs
    # float32 runs both products on the tensor cores in 3xTF32: its
    # operations are counted at the TF32 rate, as the SSD kernel's are
    bms, by = bound_ms(n_bytes, n_ops, RATE[dtype])

    def fn():
        return flash_attention(q, k, v, return_lse=lse, **kw)

    return dict(
        kernel="flash_attention", label=label, shape=dict(
            b=b, hq=hq, hkv=hkv, sq=sq, sk=sk, d=d, window=window,
            q_offset=q_offset, causal=causal), dtype=dtype, max_abs_err=err,
        err_rms=rel, ok=ok and extra.get("lse_ok", True), **extra,
        ms=time_ms(fn), fn=fn,
        plain_ms=time_ms(lambda: plain_fn(q, k, v, **kw)),
        library_ms=time_ms(sdpa(q, k, v, mask, d ** -0.5, causal)),
        bound_ms=bms, bound_by=by)


def grad_close(got, want, dtype):
    """`close` for a gradient, less one output ulp an element in bf16: both
    sides are summed in float32 and rounded once, and a gradient's largest
    values are over ten times its RMS (the first causal rows see few keys),
    so one bf16 rounding that falls the other way is ~9% of the RMS by
    itself. What is left beyond that ulp is held to REL_RMS."""
    import torch
    if dtype != "bfloat16":
        return close(got, want, dtype)
    got, want = got.float(), want.float()
    err = (got - want).abs()
    ulp = torch.ldexp(torch.ones_like(want), torch.frexp(want).exponent - 8)
    rms = want.pow(2).mean().sqrt().item()
    rel = (err - ulp).clamp(min=0).max().item() / max(rms, 1e-30)
    ok = torch.allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype]) \
        and rel <= REL_RMS and rms > 0
    return err.max().item(), rel, ok


def check_flash_grad(case, dev):
    """FlashAttentionFn forward + backward (the kernel writing its
    logsumexp, then the FlashAttention-2 backward in plain PyTorch) against
    autograd through the plain version, and beside SDPA's forward +
    backward, a yardstick the port never calls. `ms` is forward +
    backward; `bwd_ms` the backward alone."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (
        FlashAttentionFn, flash_attention, flash_backward,
    )
    b, hq, hkv, sq, sk, d, window, q_offset, dtype, label = case
    causal, scale = True, d ** -0.5
    ins = [t.requires_grad_(True) for t in flash_inputs(case, dev, seed=6)]
    dout = torch.randn(b, hq, sq, d, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(7)
                       ).to(ins[0].dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset, scale=scale)

    def fwd_bwd():
        out = FlashAttentionFn.apply(*ins, causal, window, q_offset, scale)
        return torch.autograd.grad(out, ins, dout)

    def plain_fwd_bwd():
        out = ref.flash_attention_ref(*ins, **kw)
        return torch.autograd.grad(out, ins, dout)

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(*ins, is_causal=True,
                                             scale=scale, enable_gqa=True)
        return torch.autograd.grad(out, ins, dout)

    got, want = fwd_bwd(), plain_fwd_bwd()
    torch.cuda.synchronize()
    checks = [grad_close(g, w, dtype) for g, w in zip(got, want, strict=True)]
    with torch.no_grad():
        _, lse = flash_attention(*ins, return_lse=True, **kw)
    pairs = visible_pairs(sq, sk, window, q_offset)
    elem = ins[0].element_size()
    # forward: q, k, v in, out and lse out; backward: q, k, v, dout and lse
    # in, dq, dk, dv out. Operations: the forward's two products, the
    # backward's five (s recomputed, dv, dp, dq, dk)
    n_bytes = elem * (2 * b * hq * sq * d + 2 * b * hkv * sk * d) \
        + elem * (2 * b * hq * sq * d + 2 * b * hkv * sk * d) \
        + elem * (b * hq * sq * d + 2 * b * hkv * sk * d) + 8 * b * hq * sq
    n_ops = 14.0 * d * b * hq * pairs
    bms, by = bound_ms(n_bytes, n_ops, RATE[dtype])
    return dict(
        kernel="flash_attention", label=label, shape=dict(
            b=b, hq=hq, hkv=hkv, sq=sq, sk=sk, d=d, window=window,
            q_offset=q_offset, causal=causal), dtype=dtype,
        max_abs_err=max(c[0] for c in checks),
        err_rms=max(c[1] for c in checks), ok=all(c[2] for c in checks),
        ms=time_ms(fwd_bwd, iters=10), fn=fwd_bwd,
        bwd_ms=time_ms(lambda: flash_backward(*ins, lse, dout, **kw),
                       iters=10),
        plain_ms=time_ms(plain_fwd_bwd, iters=5),
        library_ms=time_ms(sdpa_fwd_bwd, iters=10),
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
        fn=lambda: decode_attention(q, k, v, vl, scale=scale),
        plain_ms=time_ms(lambda: ref.decode_attention_ref(q, k, v, vl,
                                                          scale=scale)),
        library_ms=time_ms(sdpa(q4, k, v, mask, scale)),
        bound_ms=bms, bound_by=by)


def check_decode_lse(case, dev):
    """The decode kernel with its logsumexp against the plain versions."""
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

    def run():
        return decode_attention(q, k, v, vl, scale=scale, return_lse=True)
    out, lse = run()
    torch.cuda.synchronize()
    plain, plain_lse = ref.decode_attention_lse_ref(q, k, v, vl, scale=scale)
    err, rel, ok = close(out, plain, dtype)
    live = vl > 0
    lse_err = (lse - plain_lse)[live].abs().max().item()
    # a row with no valid slot: -1e30 + log(S), which weighs zero
    empty_ok = bool((lse[~live] <= -1e29).all())
    lse_ok = lse_err <= LSE_TOL[dtype] * max(
        1.0, plain_lse[live].abs().max().item())
    slots = sum(min(x, s) if x > 0 else s for x in valid)
    elem = q.element_size()
    n_bytes = elem * (2 * b * hq * d + 2 * hkv * slots * d) + 4 * b \
        + 4 * b * hq
    bms, by = bound_ms(n_bytes, 4.0 * d * hq * slots, dtype)
    return dict(
        kernel="decode_attention_lse", label=label, shape=dict(
            b=b, hq=hq, hkv=hkv, s=s, d=d, valid_len=list(valid)),
        dtype=dtype, max_abs_err=err, err_rms=rel, lse_err=lse_err,
        ok=ok and lse_ok and empty_ok, ms=time_ms(run), fn=run,
        plain_ms=time_ms(lambda: ref.decode_attention_lse_ref(
            q, k, v, vl, scale=scale)),
        library_ms=None, bound_ms=bms, bound_by=by)


def check_cp(case, dev):
    """The CP decode body on one process: each shard's decode with its
    logsumexp over its slice of the cache, then the combine, against the
    JAX body's einsum form and the whole-cache decode."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    hq, hkv, s, d, valid, shards, dtype, label = case
    b = len(valid)
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn(b, hq, d, generator=gen, device=dev).to(dt)
    k = torch.randn(b, hkv, s, d, generator=gen, device=dev).to(dt)
    v = torch.randn(b, hkv, s, d, generator=gen, device=dev).to(dt)
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    sl = s // shards
    ks = [k[:, :, i * sl:(i + 1) * sl] for i in range(shards)]
    vs = [v[:, :, i * sl:(i + 1) * sl] for i in range(shards)]
    vls = [torch.clamp(vl - i * sl, 0, sl).to(torch.int32)
           for i in range(shards)]
    scale = d ** -0.5

    def run():
        parts = [decode_attention(q, kk, vv, ll, scale=scale,
                                  return_lse=True)
                 for kk, vv, ll in zip(ks, vs, vls, strict=True)]
        lse = torch.stack([p[1] for p in parts])
        w = torch.exp(lse - lse.amax(0))
        num = (w[..., None] * torch.stack([p[0].float() for p in parts]))
        return (num.sum(0) / w.sum(0)[..., None]).to(dt)
    out = run()
    torch.cuda.synchronize()
    plain = ref.cp_decode_ref(q, ks, vs, vls, scale=scale).to(dt)
    whole = ref.decode_attention_ref(q, k, v, vl, scale=scale)
    err, rel, ok = close(out, plain, dtype)
    err_w, _, ok_w = close(out, whole, dtype)
    slots = sum(min(x, s) if x > 0 else s for x in valid)
    elem = q.element_size()
    n_bytes = elem * (2 * b * hq * d + 2 * hkv * slots * d) + 4 * b
    bms, by = bound_ms(n_bytes, 4.0 * d * hq * slots, dtype)
    mask = (torch.arange(s, device=dev)[None, :] < vl[:, None])[:, None, None]
    return dict(
        kernel="cp_decode", label=label, shape=dict(
            b=b, hq=hq, hkv=hkv, s=s, d=d, shards=shards,
            valid_len=list(valid)),
        dtype=dtype, max_abs_err=err, err_rms=rel, whole_err=err_w,
        ok=ok and ok_w, ms=time_ms(run), fn=run,
        plain_ms=time_ms(lambda: ref.cp_decode_ref(q, ks, vs, vls,
                                                   scale=scale)),
        library_ms=time_ms(sdpa(q[:, :, None], k, v, mask, scale)),
        bound_ms=bms, bound_by=by)


def check_paged(case, dev):
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_attention
    hq, hkv, d, page, n_pages, valid, dtype, label = case
    b = len(valid)
    n_pool = b * n_pages + 3
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn(b, hq, d, generator=gen, device=dev).to(dt)
    # pools in the model layout (n_pool, page, Hkv, D), read as views
    kp = torch.randn(n_pool, page, hkv, d, generator=gen, device=dev).to(dt)
    vp = torch.randn(n_pool, page, hkv, d, generator=gen, device=dev).to(dt)
    kt, vt = kp.transpose(1, 2), vp.transpose(1, 2)
    perm = torch.randperm(n_pool, generator=gen, device=dev)[: b * n_pages]
    tables = perm.reshape(b, n_pages).to(torch.int32)
    tables[0, -1] = 0                   # a pad entry on page 0
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    scale = d ** -0.5
    out = paged_attention(q, kt, vt, tables, vl, scale=scale)
    torch.cuda.synchronize()
    plain = ref.paged_attention_ref(q, kt, vt, tables, vl, scale=scale)
    err, rel, ok = close(out, plain, dtype)
    yardstick = {}
    if label.startswith("long"):
        # the decode kernel on the same slots laid out densely
        from repro_torch.kernels.decode_attention import decode_attention
        kd, vd = ref.gather_pages(kt, tables), ref.gather_pages(vt, tables)
        yardstick["dense_fn"] = lambda: decode_attention(q, kd, vd, vl,
                                                         scale=scale)
    span = n_pages * page
    slots = sum(min(x, span) if x > 0 else span for x in valid)  # slots read
    elem = q.element_size()
    n_bytes = elem * (2 * b * hq * d + 2 * hkv * slots * d) \
        + 4 * (b * n_pages + b)
    n_ops = 4.0 * d * hq * slots
    bms, by = bound_ms(n_bytes, n_ops, dtype)
    return dict(
        kernel="paged_attention", label=label, shape=dict(
            b=b, hq=hq, hkv=hkv, d=d, page=page, n_pages=n_pages,
            valid_len=list(valid)),
        dtype=dtype, max_abs_err=err, err_rms=rel, ok=ok,
        # the kernel alone on tables already checked, then with the
        # wrapper's page-id check (a device round trip a call)
        ms=time_ms(lambda: paged_attention(q, kt, vt, tables, vl,
                                           scale=scale, check_pages=False)),
        fn=lambda: paged_attention(q, kt, vt, tables, vl, scale=scale,
                                   check_pages=False),
        checked_ms=time_ms(lambda: paged_attention(q, kt, vt, tables, vl,
                                                   scale=scale)),
        plain_ms=time_ms(lambda: ref.paged_attention_ref(
            q, kt, vt, tables, vl, scale=scale)),
        library_ms=None, bound_ms=bms, bound_by=by, **yardstick)


def check_ssd(case, dev):
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_diag import ssd_diag
    b, s, h, p, n, chunk, label = case
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(b, s, h, p, generator=gen, device=dev)
    dt = torch.nn.functional.softplus(
        torch.randn(b, s, h, generator=gen, device=dev) - 1)
    A = -torch.exp(torch.randn(h, generator=gen, device=dev) * 0.3)
    Bm = torch.randn(b, s, n, generator=gen, device=dev) * 0.3
    Cm = torch.randn(b, s, n, generator=gen, device=dev) * 0.3
    out = ssd_diag(x, dt, A, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    plain = ref.ssd_diag_ref(x, dt, A, Bm, Cm, chunk=chunk)
    err, rel, ok = close(out, plain, "float32")
    # the plain version on the card takes its sums in the kernel's own
    # order (sequential fused multiply-adds) and agrees to the bit at
    # chunks >= 128; the CPU takes them in another, so hold the kernel
    # against that too, computed in float64 from the same float32 inputs
    # and then cast, so that the check reads the kernel's rounding alone
    # and not the CPU float32 version's as well. Only an RMS criterion
    # applies there: cum reaches about -80 at chunk 256, so cum_i - cum_j, a
    # difference of two such sums, is off by ~1e-5 in float32 (a few ulps of
    # 80) and so is the decay's relative value
    cpu_plain = ref.ssd_diag_ref(*(a.cpu() for a in (x, dt, A, Bm, Cm)),
                                 chunk=chunk, dtype=torch.float64)
    cpu_err, cpu_rel, _ = close(out.cpu(), cpu_plain, "float32")
    cpu_ok = cpu_rel <= CPU_REL_RMS
    q = min(chunk, s)
    pairs = q * (q + 1) // 2            # the causal half of a chunk
    # the function's operations, not the kernel's: C·Bᵀ is the same for
    # every head (one group), so once a chunk; (C·Bᵀ ⊙ L)·(dt·x) once a head.
    # The kernel runs both products on the tensor cores (3xTF32), so the
    # operations are counted at the TF32 tensor-core rate
    n_ops = 2.0 * pairs * b * (s // q) * (n + p * h)
    n_bytes = 4 * (2 * b * s * h * p + b * s * h + h + 2 * b * s * n)
    bms, by = bound_ms(n_bytes, n_ops, "tf32")
    return dict(
        kernel="ssd_diag", label=label, shape=dict(
            b=b, s=s, h=h, p=p, n=n, chunk=q),
        dtype="float32", max_abs_err=err, err_rms=rel, ok=ok and cpu_ok,
        cpu_err=cpu_err, cpu_err_rms=cpu_rel, out_rms=out.pow(2).mean().sqrt().item(),
        ms=time_ms(lambda: ssd_diag(x, dt, A, Bm, Cm, chunk=chunk)),
        fn=lambda: ssd_diag(x, dt, A, Bm, Cm, chunk=chunk),
        plain_ms=time_ms(lambda: ref.ssd_diag_ref(x, dt, A, Bm, Cm,
                                                  chunk=chunk), iters=5),
        library_ms=None, bound_ms=bms, bound_by=by)


def tensor_core_selftest(dev) -> None:
    """The bf16 flash kernel's tensor-core path on one tile at each
    head_dim (48 and 96 zero-padded to 64 and 128 columns in shared
    memory), through its own loaders, swizzle, descriptors and wgmma
    calls: S = Q·Kᵀ and O = bf16(S)·V against plain matrix products on the
    same tile. Fails the run on a mismatch."""
    import torch
    from repro_torch.kernels.flash_attention import tensor_core_selftest \
        as selftest
    gen = torch.Generator(device=dev).manual_seed(5)
    for d in (48, 64, 96, 128, 256):
        q, k, v = ((torch.randn(64, d, generator=gen, device=dev) * 0.5)
                   .to(torch.bfloat16) for _ in range(3))
        s, o = selftest(q, k, v)
        torch.cuda.synchronize()
        s_want = q.float() @ k.float().T
        o_want = s.to(torch.bfloat16).float() @ v.float()
        s_err = (s - s_want).abs().max().item()
        o_err = (o - o_want).abs().max().item()
        ok = torch.allclose(s, s_want, rtol=1e-4, atol=1e-3) \
            and torch.allclose(o, o_want, rtol=1e-4, atol=1e-3)
        print(f"tensor-core self-test D={d}: S err={s_err:.3e} O "
              f"err={o_err:.3e} {'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            fail(f"the tensor-core self-test disagrees at D={d}")


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
    (1, 32, 8, 2048, 2048, 128, 0, 0, "bfloat16", "long: llama3-8b heads"),
    (1, 16, 8, 4096, 4096, 256, 1024, 0, "bfloat16",
     "long: gemma3 window 1024"),
    # MLA prefill attends at head_dim qk_nope + qk_rope: 96 for minicpm3-4b's
    # 40 heads, 48 for the reduced engines' 2
    (1, 40, 40, 32, 32, 96, 0, 0, "bfloat16",
     "path: minicpm3-4b MLA prefill, bucket 32"),
    (1, 40, 40, 32, 32, 96, 0, 0, "float32", "minicpm3-4b MLA heads, f32"),
    (1, 40, 40, 2048, 2048, 96, 0, 0, "bfloat16", "long: minicpm3-4b MLA D96"),
    (1, 40, 40, 2048, 2048, 96, 0, 0, "float32",
     "long: minicpm3-4b MLA D96, f32"),
    (1, 2, 2, 16, 16, 48, 0, 0, "float32", "path: reduced MLA D48, f32"),
    (1, 2, 2, 16, 16, 48, 0, 0, "bfloat16", "reduced MLA D48"),
    # deepseek-moe-16b: 16 heads on 16 kv-heads (G = 1), D 128; mixtral's 32
    # on 8 with a window of 4096 that a 256-slot engine never reaches
    (1, 16, 16, 32, 32, 128, 0, 0, "bfloat16",
     "path: deepseek-moe-16b prefill, bucket 32"),
    (1, 16, 16, 4096, 4096, 128, 0, 0, "bfloat16",
     "long: deepseek-moe-16b heads S=4096"),
    (1, 32, 8, 32, 32, 128, 4096, 0, "bfloat16",
     "path: mixtral-8x7b prefill, bucket 32"),
    # recurrentgemma-2b's attention layers: 10 q-heads on 1 kv-head, D 256,
    # window 2048 (binding past S = 2048: tests/test_torch_gpu.py runs
    # S = 2500); qwen2-vl-2b's 12 on 2 at D 128
    (1, 10, 1, 32, 32, 256, 2048, 0, "bfloat16",
     "path: recurrentgemma-2b prefill, bucket 32"),
    (1, 10, 1, 32, 32, 256, 2048, 0, "float32", "recurrentgemma-2b heads, f32"),
    (1, 10, 1, 2048, 2048, 256, 2048, 0, "bfloat16",
     "long: recurrentgemma-2b heads"),
    (1, 12, 2, 32, 32, 128, 0, 0, "bfloat16",
     "path: qwen2-vl-2b prefill, bucket 32"),
    (1, 12, 2, 32, 32, 128, 0, 0, "float32", "qwen2-vl-2b heads, f32"),
    (1, 12, 2, 2048, 2048, 128, 0, 0, "bfloat16", "long: qwen2-vl-2b heads"),
    # phase 11's ranks at model 2: minicpm3's 20 MLA heads, recurrentgemma's
    # 5 q-heads on its gathered kv-head, qwen2-vl's 6 on 1
    (1, 20, 20, 32, 32, 96, 0, 0, "bfloat16",
     "path: sharded minicpm3-4b, 20 heads, bucket 32"),
    (1, 5, 1, 32, 32, 256, 2048, 0, "bfloat16",
     "path: sharded recurrentgemma-2b, 5 on 1"),
    (1, 6, 1, 32, 32, 128, 0, 0, "bfloat16",
     "path: sharded qwen2-vl-2b, 6 on 1, bucket 32"),
    # phase 12's deployments at full width: llama2-33b's 52 heads on 52
    # (MHA), llama2-7b's 32 on 32, yi's 32 on 4 (8 a kv-head), llama3-8b's
    # 32 on 8, all D 128, bucket 32; gemma3-12b's 16 on 8 at D 256 and
    # gemma3-27b's 32 on 16 at D 128 in the 2048 bucket, local layers
    # windowed to 1024 and global ones causal
    (1, 52, 52, 32, 32, 128, 0, 0, "bfloat16",
     "path: llama2-33b prefill, bucket 32"),
    (1, 52, 52, 32, 32, 128, 0, 0, "float32", "llama2-33b heads, f32"),
    (1, 32, 32, 32, 32, 128, 0, 0, "bfloat16",
     "path: llama2-7b prefill, bucket 32"),
    (1, 32, 4, 32, 32, 128, 0, 0, "bfloat16",
     "path: yi-6b / yi-9b prefill, bucket 32"),
    (1, 32, 8, 32, 32, 128, 0, 0, "bfloat16",
     "path: llama3-8b prefill, bucket 32"),
    (1, 16, 8, 2048, 2048, 256, 1024, 0, "bfloat16",
     "path: gemma3-12b local prefill, bucket 2048"),
    (1, 16, 8, 2048, 2048, 256, 0, 0, "bfloat16",
     "path: gemma3-12b global prefill, bucket 2048"),
    (1, 16, 8, 1024, 1024, 256, 1024, 0, "float32",
     "gemma3-12b local, bucket 1024, f32"),
    (1, 32, 16, 2048, 2048, 128, 1024, 0, "bfloat16",
     "path: gemma3-27b local prefill, bucket 2048"),
]
# whisper-base (8 q-heads on 8 kv-heads, D 64, 1500 frames): the encoder
# and cross attention, bidirectional
NONCAUSAL_FLASH_CASES = [
    (4, 8, 8, 1500, 1500, 64, 0, 0, "bfloat16",
     "path: whisper-base encoder, B4 1500 frames"),
    (4, 8, 8, 1500, 1500, 64, 0, 0, "float32", "whisper-base encoder, f32"),
    (4, 8, 8, 1, 1500, 64, 0, 0, "bfloat16", "path: whisper-base cross, decode"),
    (4, 8, 8, 1, 1500, 64, 0, 0, "float32", "whisper-base cross decode, f32"),
    (4, 8, 8, 32, 1500, 64, 0, 0, "bfloat16", "whisper-base cross, Sq 32"),
    (4, 8, 8, 32, 1500, 64, 0, 0, "float32", "whisper-base cross Sq 32, f32"),
    # phase 11's sharded whisper: 2 rows and 4 heads a rank
    (2, 4, 4, 1500, 1500, 64, 0, 0, "bfloat16",
     "path: sharded whisper-base encoder, 4 heads"),
]
# the kernel writing its logsumexp (for the backward), causal and not
LSE_CASES = [
    ((1, 8, 1, 32, 32, 256, 0, 0, "bfloat16", "lse: gemma-2b path"), True),
    ((1, 8, 1, 32, 32, 256, 0, 0, "float32", "lse: gemma-2b path, f32"), True),
    ((4, 8, 1, 256, 256, 256, 0, 0, "bfloat16", "lse: gemma-2b training"),
     True),
    ((4, 8, 8, 1500, 1500, 64, 0, 0, "bfloat16", "lse: whisper-base encoder"),
     False),
    ((4, 8, 8, 1500, 1500, 64, 0, 0, "float32",
      "lse: whisper-base encoder, f32"), False),
]
# FlashAttentionFn's gradients at gemma-2b's training shape (B4, 256 tokens)
GRAD_CASES = [
    (4, 8, 1, 256, 256, 256, 0, 0, "bfloat16", "grad: gemma-2b training"),
    (4, 8, 1, 256, 256, 256, 0, 0, "float32", "grad: gemma-2b training, f32"),
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
    (8, 1, 4096, 256, [4096] * 4, "bfloat16", "long: gemma-2b B=4 S=4096"),
    (16, 16, 256, 128, [20, 27, 33, 41], "bfloat16",
     "path: deepseek-moe-16b decode"),
    (16, 16, 4096, 128, [4096] * 32, "bfloat16",
     "long: deepseek-moe-16b B=32 S=4096"),
    (32, 8, 256, 128, [20, 27, 33, 41], "bfloat16",
     "path: mixtral-8x7b decode"),
    # 10 q-heads a kv-head: the bf16 kernel's 16-row tile, float32 in two
    # sub-groups of 5; the long rows read the gemma-2b rows' K/V bytes
    (10, 1, 256, 256, [20, 27, 33, 41], "bfloat16",
     "path: recurrentgemma-2b decode"),
    (10, 1, 256, 256, [20, 27, 33, 41], "float32",
     "path: recurrentgemma-2b decode, f32"),
    (10, 1, 4096, 256, [4096] * 32, "bfloat16",
     "long: recurrentgemma-2b B=32 S=4096"),
    (10, 1, 4096, 256, [4096] * 32, "float32",
     "long: recurrentgemma-2b B=32 S=4096, f32"),
    (16, 1, 1024, 128, [0, 1, 300, 1024], "bfloat16", "G 16, valid 0"),
    (16, 1, 1024, 128, [0, 1, 300, 1024], "float32", "G 16, valid 0, f32"),
    (12, 2, 256, 128, [20, 27, 33, 41], "bfloat16", "path: qwen2-vl-2b decode"),
    # phase 11's ranks at model 2: recurrentgemma's 5 q-heads a rank on its
    # one kv-head (a cache whose batch is whole: the prefix-hit and batch-1
    # shapes), qwen2-vl's 6 on 1
    (5, 1, 256, 256, [20, 27, 33, 41], "bfloat16",
     "sharded recurrentgemma-2b, 5 on 1"),
    (6, 1, 256, 128, [20, 27, 33, 41], "bfloat16",
     "path: sharded qwen2-vl-2b decode, 6 on 1"),
    # phase 12's deployments: the paper models' 256 slots; gemma3's local
    # layers roll in 1024 slots (every row past the window reads all 1024),
    # its global layers hold 2048
    (52, 52, 256, 128, [20, 27, 33, 41], "bfloat16",
     "path: llama2-33b decode"),
    (52, 52, 256, 128, [20, 27, 33, 41], "float32", "llama2-33b heads, f32"),
    (32, 32, 256, 128, [20, 27, 33, 41], "bfloat16", "path: llama2-7b decode"),
    (32, 4, 256, 128, [20, 27, 33, 41], "bfloat16",
     "path: yi-6b / yi-9b decode"),
    (32, 8, 256, 128, [20, 27, 33, 41], "bfloat16", "path: llama3-8b decode"),
    (16, 8, 1024, 256, [1024, 1024, 1024, 700], "bfloat16",
     "path: gemma3-12b rolling local decode"),
    (16, 8, 1024, 256, [1024, 1024, 1024, 700], "float32",
     "gemma3-12b rolling local decode, f32"),
    (16, 8, 2048, 256, [1500, 1100, 1916, 700], "bfloat16",
     "path: gemma3-12b global decode"),
    (32, 16, 1024, 128, [1024, 1024, 1024, 700], "bfloat16",
     "path: gemma3-27b rolling local decode"),
]
# the decode kernel writing each row's logsumexp (the context-parallel
# decode's shard partial): phase 11's shard of gemma-2b's CP decode (2 rows,
# 8 q-heads, 128 of 256 slots, one shard past the rows' lengths), and the
# long rows of DECODE_CASES, whose device time without lse is beside them
DECODE_LSE_CASES = [
    (8, 1, 128, 256, [65, 0], "bfloat16", "path: gemma-2b CP shard"),
    (8, 1, 128, 256, [65, 0], "float32", "gemma-2b CP shard, f32"),
    (10, 1, 128, 256, [20, 0], "bfloat16",
     "path: sharded recurrentgemma-2b CP shard"),
    (8, 1, 4096, 256, [4096] * 32, "bfloat16", "long: gemma-2b B=32 S=4096"),
    (16, 16, 4096, 128, [4096] * 32, "bfloat16",
     "long: deepseek-moe-16b B=32 S=4096"),
    (16, 1, 1024, 128, [0, 1, 300, 1024], "float32", "G 16, valid 0, f32"),
]
# the CP decode body on one process: (hq, hkv, s, d, valid_len per row,
# shards, dtype, label); each shard's decode-with-lse and the combine
# against the JAX body's einsum form (ref.cp_decode_ref)
CP_CASES = [
    (8, 1, 256, 256, [65, 65, 65, 65], 2, "bfloat16",
     "path: gemma-2b CP, 2 shards"),
    (8, 1, 256, 256, [65, 65, 65, 65], 2, "float32",
     "gemma-2b CP, 2 shards, f32"),
    (8, 1, 4096, 256, [4096] * 32, 4, "bfloat16",
     "long: gemma-2b B=32 S=4096, 4 shards"),
]
# (hq, hkv, d, page, n_pages, valid_len per row, dtype, label); shuffled
# tables with a pad entry on page 0
PAGED_CASES = [
    (8, 1, 256, 16, 16, [20, 27, 0, 41], "bfloat16",
     "path: gemma-2b pool, page 16"),
    (8, 1, 256, 16, 16, [20, 27, 0, 41], "float32", "gemma-2b pool, f32"),
    (8, 2, 64, 16, 8, [0, 57, 128, 5], "bfloat16", "D 64, GQA"),
    (8, 2, 64, 16, 8, [0, 57, 128, 5], "float32", "D 64, GQA, f32"),
    (16, 4, 128, 16, 8, [128, 77, 1, 0], "bfloat16", "D 128"),
    (16, 4, 128, 16, 8, [128, 77, 1, 0], "float32", "D 128, f32"),
    (8, 2, 48, 16, 8, [1, 100], "bfloat16", "D 48"),
    (8, 2, 80, 16, 8, [128, 5], "float32", "D 80, f32"),
    (8, 1, 256, 16, 256, [4096] * 32, "bfloat16",
     "long: gemma-2b B=32 4096 tokens"),
    (8, 1, 256, 16, 256, [4096] * 32, "float32",
     "long: gemma-2b B=32 4096 tokens, f32"),
    (10, 1, 256, 16, 16, [20, 27, 0, 41], "bfloat16",
     "path: recurrentgemma-2b pool, page 16"),
    (10, 1, 256, 16, 16, [20, 27, 0, 41], "float32",
     "recurrentgemma-2b pool, f32"),
    (10, 1, 256, 16, 256, [4096] * 32, "bfloat16",
     "long: recurrentgemma-2b B=32 4096 tokens"),
    (10, 1, 256, 16, 256, [4096] * 32, "float32",
     "long: recurrentgemma-2b B=32 4096 tokens, f32"),
    (6, 1, 128, 16, 16, [40, 27, 0, 41], "bfloat16",
     "path: sharded qwen2-vl-2b pool, 6 on 1"),
    # phase 12's paged gemma3-12b: its global layers' pools (16 q-heads on 8,
    # D 256), 2048 tokens a table
    (16, 8, 256, 16, 128, [1018, 1500, 0, 1916], "bfloat16",
     "path: gemma3-12b global pool, page 16"),
    (16, 8, 256, 16, 128, [1018, 1500, 0, 1916], "float32",
     "gemma3-12b global pool, f32"),
]
# (b, s, h, p, n, chunk, label): mamba2-2.7b's 80 heads of 64, state 128;
# the engine's prompt buckets give chunk = min(256, bucket)
SSD_CASES = [
    (1, 256, 80, 64, 128, 256, "path: mamba2-2.7b prefill, bucket 256"),
    (1, 8, 80, 64, 128, 8, "mamba2-2.7b, bucket 8"),
    (1, 16, 80, 64, 128, 16, "mamba2-2.7b, bucket 16"),
    (1, 32, 80, 64, 128, 32, "mamba2-2.7b, bucket 32"),
    (1, 128, 80, 64, 128, 128, "path: mamba2-2.7b prefill, bucket 128"),
    (1, 2048, 80, 64, 128, 256, "long: mamba2-2.7b S=2048 chunk 256"),
    # phase 11's ranks at model 2: 40 heads a rank
    (1, 256, 40, 64, 128, 256, "sharded mamba2-2.7b, 40 heads, S=256"),
    (1, 32, 40, 64, 128, 32, "path: sharded mamba2-2.7b, 40 heads, "
                             "bucket 32"),
]


# ---------------------------------------------------------------------------
# phases 4 and 5: the port's main path
# ---------------------------------------------------------------------------


# arch: (reduced widths, max_seq, prompt lengths, new tokens). gemma3-12b's
# local layers keep a rolling cache of 64 slots: its 70-token prompt is
# prefilled into the last 64 slots and every request decodes past the window.
# mamba2's prompts are no powers of two (the bucket padding runs through the
# recurrence) and its 70-token prompt spans 8 chunks of 16. mixtral's rolling
# window is 64 slots too; minicpm3's MLA prefill runs flash at head_dim 48.
# recurrentgemma's prompts are no powers of two either (the padding runs
# through its RG-LRU states); at 64 slots its 64-slot window fills the
# cache, so a paged engine pages its K/V. qwen2-vl prefills with M-RoPE's
# (3, 1, S) streams.
SMALL_ENGINES = {
    "gemma-2b": (dict(n_layers=2, d_model=256, vocab_size=512), 64,
                 [3, 7, 11, 15, 19], 8),
    "gemma3-12b": (dict(n_layers=2, d_model=128, vocab_size=512), 128,
                   [45, 52, 60, 70], 24),
    "mamba2-2.7b": (dict(n_layers=2, d_model=256, vocab_size=512), 128,
                    [5, 13, 29, 70], 8),
    "deepseek-moe-16b": (dict(n_layers=2, d_model=128, vocab_size=512), 64,
                         [3, 7, 11, 15, 19], 8),
    "mixtral-8x7b": (dict(n_layers=2, d_model=128, vocab_size=512), 128,
                     [45, 52, 60, 70], 24),
    "minicpm3-4b": (dict(n_layers=2, d_model=128, vocab_size=512), 64,
                    [3, 7, 11, 15, 19], 8),
    "recurrentgemma-2b": (dict(n_layers=3, d_model=128, vocab_size=512), 64,
                          [5, 13, 29, 45], 16),
    "qwen2-vl-2b": (dict(n_layers=2, d_model=128, vocab_size=512), 64,
                    [3, 7, 11, 15, 19], 8),
    # the deployments of phase 12: llama2 stays MHA reduced (4 on 4),
    # llama3-8b keeps 4 q-heads a kv-head; gemma3-27b rolls past its 64-slot
    # window as gemma3-12b does
    "llama2-7b": (dict(n_layers=2, d_model=256, vocab_size=512), 64,
                  [3, 7, 11, 15, 19], 8),
    "llama3-8b": (dict(n_layers=2, d_model=256, vocab_size=512), 64,
                  [3, 7, 11, 15, 19], 8),
    "llama2-33b": (dict(n_layers=2, d_model=256, vocab_size=512), 64,
                   [3, 7, 11, 15, 19], 8),
    "gemma3-27b": (dict(n_layers=2, d_model=128, vocab_size=512), 128,
                   [45, 52, 60, 70], 24),
}
# full-width MoE and MLA engines: (arch, launcher flags beyond SERVE_ARGS',
# layers kept). mixtral-8x7b's 32 layers are 93 GB in bf16, beyond one card:
# it keeps 4 at full width.
BIG_ENGINES = [
    ("deepseek-moe-16b", [], None),
    ("minicpm3-4b", [], None),
    ("minicpm3-4b", ["--paged"], None),
    ("mixtral-8x7b", [], 4),
]
# phase 9, the RG-LRU hybrid and M-RoPE families at full width, in the same
# form
NEW_ENGINES = [
    ("recurrentgemma-2b", [], None),
    ("recurrentgemma-2b", ["--paged"], None),
    ("qwen2-vl-2b", [], None),
]
# phase 12: the paper's deployment models (configs/paper_models.py: the
# edge models yi-6b, llama2-7b, llama3-8b, yi-9b and the cloud's
# llama2-33b, 60.6 GiB of bf16 weights, the largest one card holds) and the
# gemma3 pair (the serving example's cloud engine, gemma3-12b, and the TPU
# testbed's, gemma3-27b), each at full width and depth in bf16 through the
# launcher's engine and freed before the next; no depth is cut. The paper
# models serve SERVE_ARGS' requests. gemma3 takes prompts of 600-1900
# tokens into 2048 slots (the launcher's seed gives 640-1790): those above
# 1024 tokens fall in the 2048 bucket, whose last 1024 slots the local
# layers' rolling cache keeps at prefill (the JAX engine's bucket padding,
# ROADMAP §3), and decode in the rolling window (valid_len 1024); the rest
# prefill the 1024 bucket whole. gemma3-12b runs again paged, with a pool
# of DEPLOY_PAGED_BLOCKS blocks of 16 tokens (a request needs 41-113:
# fewer than the 4 lanes fit, admission stalls); only its 8 global layers
# are paged, its 40 local layers' 1024-slot windows go through the
# snapshot. Each engine's warm run is followed by DEPLOY_TRACED_STEPS
# decode steps under torch.profiler (host launches a step, busy share).
GEMMA3_FLAGS = ["--max-seq", "2048", "--prompt-len", "600", "1900"]
DEPLOY_PAGED_BLOCKS = 250
DEPLOY_ENGINES = [
    ("yi-6b", []),
    ("llama2-7b", []),
    ("llama3-8b", []),
    ("yi-9b", []),
    ("llama2-33b", []),
    ("gemma3-12b", GEMMA3_FLAGS),
    ("gemma3-12b", GEMMA3_FLAGS + ["--paged", str(DEPLOY_PAGED_BLOCKS)]),
    ("gemma3-27b", GEMMA3_FLAGS),
]
DEPLOY_TRACED_STEPS = 4
# the paged gemma3-12b engine's eviction: a prompt in the 1024 bucket,
# evicted 8 steps in and resumed, rolls past slot 1024 after the resume
DEPLOY_POOL_PROMPT = 1010
# the three examples of phase 12: train_100m's steps on the card
TRAIN_100M_STEPS = 200
# phase 10: whisper-base's 4 requests (prompt lengths) and decode steps;
# gemma-2b trained through the launcher; the families trained reduced
WHISPER_PROMPTS = (4, 9, 16, 23)
WHISPER_STEPS = 16
TRAIN_ARGS = ["--arch", "gemma-2b", "--steps", "4", "--batch", "4", "--seq",
              "256", "--device", "cuda", "--log-every", "1"]
TRAIN_ARCHS = ["gemma-2b", "gemma3-12b", "mamba2-2.7b", "deepseek-moe-16b",
               "mixtral-8x7b", "minicpm3-4b", "recurrentgemma-2b",
               "qwen2-vl-2b", "whisper-base"]
# phase 11: the sharded paths, 4 ranks over gloo on a (2, 2) ("data",
# "model") mesh of the one card. gemma-2b's context-parallel decode: 4 rows
# of a 64-token prompt in a 256-slot cache (its sequence over "model", 128
# slots a shard); the sharded engine serves phase 4's 8 requests.
SHARD_MESH = (2, 2)
CP_ROWS, CP_PROMPT, CP_SLOTS = 4, 64, 256
SHARD_SERVE = dict(requests=8, max_new=16, max_batch=4, max_seq=256,
                   prompt_len=(4, 24))
SHARD_TRACED_STEPS = 4       # decode steps of rank 0's traced run
# deepseek-moe-16b at full width with its depth cut to 6 layers (1 dense, 5
# MoE): each expert-parallel layer re-lays its F-split experts by all-to-all
# (0.55 GB a rank a layer through gloo), which at 28 layers would take
# minutes; 2 rows of a 32-token prompt. Through the model the dispatches
# keep the JAX package's capacity factor (1.25); the ep_a2a layer is also
# held alone, at layer MOE_CHECK_LAYER on a seeded input, at capacity 16,
# above 64 experts / top-6: an expert can take every local token, so none
# is dropped and it holds to dense dispatch (at 8, tokens that share their
# experts overflow: a random model's hidden states route alike)
MOE_LAYERS, MOE_ROWS, MOE_PROMPT, MOE_CAPACITY = 6, 2, 32, 16.0
MOE_CHECK_LAYER = 1
# bf16 logits of an 18-layer model from random weights lie ~8% of their RMS
# from the same weights' float32 logits on one card, and any other order of
# the sums (a sharded run's) moves them as far (PERF.md §6): a sharded
# gemma-2b run is held to the float32 model, no further from it than 1.25x
# one card's bf16 run, or within REL_RMS of it. deepseek's bf16 logits move
# far more (routing flips on near ties: 14-237% of the RMS at decode on one
# card over two weight seeds), so its bf16 runs are printed, and its
# float32 runs are the gates
SHARD_VS_F32 = 1.25
# float32 runs differ from one rank's in the order of their sums alone
SHARD_F32_GATE = 1e-3
# the sharded train step of full-width gemma-2b at full depth (batch 4 x
# 256, as phase 10) against the single-rank step, with no warm-up
# (`SHARD_ADAMW`: the default's first step, lr 3e-6, moves only the bf16
# weights below ~1e-3).
# Each gate lies between the sound runs' readings and those of a fault, the
# single-rank step on half the batch (PERF.md §6): the loss (summed in
# float32), the gradients' global norm and the update's (relative gaps),
# and the last layer's updated weights and first moments (the ZeRO-1
# chunks the gradients' reduce-scatter, AdamW and the gather left on each
# rank) element by element: RMS of the difference over the RMS of one
# rank's update (of its moment), the largest over the ranks
SHARD_TRAIN_LAYERS = 18
SHARD_ADAMW = dict(warmup_steps=1)
SHARD_TRAIN_GATES = dict(loss=1e-3, grad_norm=1e-2, update_norm=1e-3,
                         last_params=0.5, last_moments=0.1)
# the Mamba-2, RG-LRU hybrid, MLA and M-RoPE families' sharded engines at
# full width and depth (no depth is cut), bf16, each serving phase 4's 8
# requests (SHARD_SERVE) and freed before the next: mamba2-2.7b (40 SSD
# heads a rank), recurrentgemma (1280 RG-LRU channels a rank; its one
# kv-head on a batch-split cache takes the context-parallel decode, 10
# q-heads on 128 slots a shard), minicpm3 (20 MLA heads a rank, flash at D
# 96) and qwen2-vl (text only; 6 q-heads on its 1 kv-head a rank); then
# whisper-base at the model level, SHARD_WHISPER rows with 1500 frames each
# (4 heads a rank). Each is held by its logits on CP_ROWS rows of a
# CP_PROMPT-token prompt and one decode step (whisper: its own rows): bf16
# to the float32 model as gemma-2b is (SHARD_VS_F32: no routing, so no near
# tie flips a branch). gemma-2b's sharded paged engine (an eviction, a
# resume in the other data rank's slot, a prefix hit) and the paged kernel
# on a rank's pool of qwen2-vl (1 of its 2 kv-heads a rank) run beside
# them.
SHARD_ENGINES = ("mamba2-2.7b", "recurrentgemma-2b", "minicpm3-4b",
                 "qwen2-vl-2b")
SHARD_WHISPER = dict(rows=4, prompt=16, slots=64)
SHARD_PAGED_NEW = 16
# reduced float32 engines sharded on the card against one CPU process
SHARD_SMALL = ("gemma-2b", "deepseek-moe-16b") + SHARD_ENGINES
SHARD_SMALL_PROMPTS = [[5, 9, 23, 7], [100, 3, 44, 12, 77, 8, 2], [31, 32, 33]]


def small_engine(arch: str, device: str, **kw):
    """A reduced float32 engine with seed-0 weights: on the card it runs
    the kernels, on the CPU their plain versions."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import ServingEngine
    widths, max_seq, _, _ = SMALL_ENGINES[arch]
    cfg = dataclasses.replace(get_config(arch).reduced(**widths),
                              dtype="float32")
    params = init_params(cfg, seed=0, device="cpu")
    params = {k: _to(v, device) for k, v in params.items()}
    return ServingEngine(cfg, params, max_batch=3, max_seq=max_seq,
                         device=device, **kw)


def small_engine_tokens(arch: str, device: str):
    """Greedy tokens of a reduced float32 engine."""
    _, _, lengths, new = SMALL_ENGINES[arch]
    eng = small_engine(arch, device)
    for i, n in enumerate(lengths):
        eng.submit([(7 * i + j) % eng.cfg.vocab_size for j in range(n)],
                   max_new_tokens=new)
    return [r.generated for r in sorted(eng.run_until_idle(),
                                        key=lambda r: r.rid)]


def evict_resume(eng, prompts, new: int, steps: int = 3):
    """Serve `prompts`, evicting the first request after `steps` engine
    steps and resubmitting it once the second is admitted. Returns the
    tokens of every request, in submission order."""
    reqs = [eng.submit(prompts[0], max_new_tokens=new)]
    for _ in range(steps):
        eng.step()
    victim = eng.evict(reqs[0].slot)
    if victim is not reqs[0] or victim.kv is None:
        fail("the paged engine did not snapshot the evicted request")
    reqs += [eng.submit(p, max_new_tokens=new) for p in prompts[1:]]
    eng.step()
    eng.resubmit(victim)
    eng.run_until_idle()
    return [r.generated for r in reqs]


def small_paged_run(arch: str, device: str):
    """A reduced float32 paged engine: the first request is evicted
    mid-decode and resumed from its pages; the second prompt opens with the
    first one's two full blocks (a prefix hit where the cache is all pages,
    not for mamba2 or recurrentgemma). Returns (tokens, uninterrupted dense
    tokens, prefix hits, prefills)."""
    bt = 16
    head = [(5 * j + 2) % 512 for j in range(2 * bt)]
    prompts = [head + [9, 8, 7, 6, 5], head + [1, 2, 3], [4, 5, 6, 7, 8, 9]]
    eng = small_engine(arch, device, paged=True, kv_block_tokens=bt)
    toks = evict_resume(eng, prompts, new=10)
    dense = small_engine(arch, device)
    ref = [dense.submit(p, max_new_tokens=10) for p in prompts]
    dense.run_until_idle()
    if eng.kv.free_blocks != eng.kv.n_blocks:
        fail(f"{arch}: the paged engine did not return every block")
    return (toks, [r.generated for r in ref], eng.n_prefix_hits,
            eng.n_prefills)


def has_pool(kv, layer: int) -> bool:
    """Whether the paged cache keeps `layer`'s K/V in pages (a rolling
    window shorter than the engine's slots is snapshot whole instead)."""
    try:
        kv.pool_views(layer)
    except ValueError:
        return False
    return True


def paged_pool_check(params, cfg, ctx=None, max_seq: int = 256,
                     prompt_len: int = 40):
    """Full-width paged engine (bf16): a request of `prompt_len` tokens
    evicted mid-decode. Right after the eviction the paged kernel reads
    every paged attention layer's pool through the request's page table; it
    is held against the plain version. Rolling windows shorter than
    `max_seq` are not paged: their layers' K/V go through the snapshot
    (counted in the readings). The resumed request must end with the
    uninterrupted dense engine's tokens. Returns the worst errors and, per
    paged layer, the query, the paged output and the slot's dense cache
    taken just before the eviction, for `decode_yardstick`. Under a mesh
    (``ctx``) the engines are sharded and the kernel reads this rank's
    pool: its kv-heads, with the q-heads that read them."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.models.transformer import block_program
    from repro_torch.serving import ServingEngine
    dev = torch.device(DEVICE)
    attn = [i for i, spec in enumerate(block_program(cfg).layers())
            if spec.kind == "attn"]
    prompt = [(13 * j + 5) % cfg.vocab_size for j in range(prompt_len)]
    dense = ServingEngine(cfg, params, max_batch=1, max_seq=max_seq,
                          device=dev, ctx=ctx)
    want = dense.submit(prompt, max_new_tokens=24)
    dense.run_until_idle()
    eng = ServingEngine(cfg, params, max_batch=1, max_seq=max_seq,
                        device=dev, paged=True, kv_block_tokens=16, ctx=ctx)
    req = eng.submit(prompt, max_new_tokens=24)
    for _ in range(8):
        eng.step()
    slot_cache = eng._extract_slot(req.slot)
    eng.evict(req.slot)
    pos = req.kv.position
    table = torch.tensor([req.pages.blocks], dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    group, d = cfg.n_heads // cfg.n_kv_heads, cfg.resolved_head_dim
    paged = [i for i in attn if has_pool(eng.kv, i)]
    worst = {"vs_plain": 0.0, "valid_len": pos,
             "pages": len(req.pages.blocks), "layers": len(paged),
             "snapshot_layers": len(attn) - len(paged),
             "snapshot_leaves": len(req.kv.state), "group": group}
    outs = []
    for layer in paged:
        kp, vp = eng.kv.pool_views(layer)
        if kp.shape[-1] != d:
            fail(f"the pool splits head_dim ({kp.shape[-1]} of {d}): the "
                 f"paged kernel takes whole kv-heads")
        hq = kp.shape[2] * group
        worst["heads"] = (hq, kp.shape[2])
        q = torch.randn(1, hq, d, generator=gen, device=dev).to(kp.dtype)
        got = ops.paged_attention(q, kp, vp, table, pos, scale=d ** -0.5,
                                  force_kernel=True)
        plain = ref.paged_attention_ref(q, kp.transpose(1, 2),
                                        vp.transpose(1, 2), table, pos,
                                        scale=d ** -0.5)
        err, _, ok = close(got, plain, str(kp.dtype).split(".")[-1])
        if not ok:
            fail(f"paged kernel on layer {layer}'s pool vs_plain: "
                 f"err {err:.3e}")
        worst["vs_plain"] = max(worst["vs_plain"], err)
        outs.append((q, got, slot_cache[layer]))
    eng.resubmit(req)
    eng.run_until_idle()
    if req.generated != want.generated or eng.n_prefills != 1:
        fail(f"the resumed request's tokens {req.generated} differ from the "
             f"uninterrupted run's {want.generated}")
    return worst, outs


def decode_yardstick(worst: dict, outs) -> None:
    """The paged kernel's outputs on the pool against the decode kernel on
    the slot's dense cache, per layer. Run outside any path's count: these
    decode launches only measure the paged ones."""
    from repro_torch.kernels import ops
    pos = worst["valid_len"]
    worst["vs_decode_kernel"] = 0.0
    for q, got, cache in outs:
        d = q.shape[-1]
        dec = ops.decode_attention(q, cache["k"], cache["v"], pos,
                                   scale=d ** -0.5, force_kernel=True)
        err, _, ok = close(got, dec, str(got.dtype).split(".")[-1])
        if not ok:
            fail(f"paged kernel on a pool vs_decode_kernel: err {err:.3e}")
        worst["vs_decode_kernel"] = max(worst["vs_decode_kernel"], err)


def full_prefix_hit(params, cfg):
    """Full-width paged engine: a prompt opening with an earlier prompt's
    two full blocks attaches them and decodes only its suffix. Returns
    the engine."""
    import torch
    from repro_torch.serving import ServingEngine
    head = [(11 * j + 3) % cfg.vocab_size for j in range(32)]
    eng = ServingEngine(cfg, params, max_batch=2, max_seq=256,
                        device=torch.device(DEVICE), paged=True,
                        kv_block_tokens=16)
    for tail in ([7, 8, 9, 10, 11], [20, 21, 22]):
        eng.submit(head + tail, max_new_tokens=8)
        eng.run_until_idle()
    return eng


def warm_engine_run(eng, prompts, profile: bool, new: int = 16) -> dict:
    """The same prompts again on the warm engine, timed on the host clock
    around work that ends in a synchronise. With `profile`, the run is
    traced with torch.profiler and the device time by kernel printed."""
    import torch
    n0 = len(eng.completed)
    for p in prompts:
        eng.submit(p, max_new_tokens=new)
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
        cuda = torch.autograd.DeviceType.CUDA
        for e in prof.key_averages():   # the port's kernels, each by name
            if e.device_type == cuda and "repro::" in e.key and e.count:
                print(f"kernel {e.key[:90]}: {e.count} launches, "
                      f"{e.self_device_time_total / e.count:.2f} us a launch")
        busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == cuda)
        # kernel launches the host made (cuBLAS's through cuLaunchKernelEx)
        launches = sum(e.count for e in prof.key_averages()
                       if e.key in ("cudaLaunchKernel", "cuLaunchKernelEx"))
        print(f"device busy {busy_us / 1e3:.1f} ms of {secs * 1e3:.1f} ms "
              f"wall ({100 * busy_us / 1e6 / secs:.1f}%); {launches} kernel "
              f"launches from the host, {launches / steps:.0f} a step")
    toks = sum(len(r.generated) for r in eng.completed[n0:])
    if len(eng.completed) - n0 != len(prompts):
        fail("the warm engine run did not finish every request")
    return dict(tokens=toks, seconds=secs, steps=steps,
                tok_per_s=toks / secs, ms_per_step=1e3 * secs / steps)


def traced_steps(eng, prompts, new: int, n: int) -> dict:
    """Host kernel launches a decode step and the device's busy share: the
    prompts once more on the warm engine, two engine steps to admit and
    prefill what fits, then `n` decode steps traced with torch.profiler
    (no request can finish, and so none is admitted, inside them: `new`
    exceeds n + 2), the rest drained untraced. The profiler slows the host,
    so the busy share is a lower bound."""
    import torch
    for p in prompts:
        eng.submit(p, max_new_tokens=new)
    for _ in range(2):
        eng.step()
    prefills = eng.n_prefills
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    if eng.n_prefills != prefills:
        fail("a prefill ran inside the traced decode steps")
    eng.run_until_idle()
    avg = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    launches = sum(e.count for e in avg
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernelEx"))
    busy = sum(e.self_device_time_total for e in avg
               if e.device_type == cuda) / 1e6
    return dict(launches_per_step=launches / n, busy_share=busy / secs,
                traced_ms_per_step=1e3 * secs / n)


def big_engine(arch, flags, n_layers, run_path, profile: bool, card: str,
               trace_steps: int = 0):
    """Phases 8, 9 and 12: `arch` at full width (bf16, random weights from
    a seed) served through the launcher's engine with SERVE_ARGS' 8
    requests (`flags` added after them), its depth cut to `n_layers` where
    given; checks the tokens, the kernels' launch counts (flash once an
    attention layer a prefill, decode once an attention layer a model
    decode step) and the logits, then serves the same prompts warm, and
    with `trace_steps` once more for that many traced decode steps
    (`traced_steps`). Returns the engine and its readings."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import forward
    args = serve.parser().parse_args(["--arch", arch] + SERVE_ARGS[2:]
                                     + flags)
    cfg = None if n_layers is None \
        else dataclasses.replace(get_config(arch), n_layers=n_layers)
    label = " ".join([arch] + flags)
    launches, (eng, done, secs) = run_path(
        label, lambda: serve.run_single(args, cfg=cfg))
    cfg = eng.cfg
    layers = cfg.n_layers
    n_attn = cfg.attention_layer_count()
    n_done, prefills, steps = len(done), eng.n_prefills, eng.n_decode_steps
    toks = sum(len(r.generated) for r in done)
    if n_done != 8 or any(len(r.generated) != 16 for r in done):
        fail(f"{label}: the engine did not finish every request")
    if any(not 0 <= t < cfg.vocab_size for r in done for t in r.generated):
        fail(f"{label}: the engine produced tokens outside the vocabulary")
    flash, dec = launches["flash_attention"], launches["decode_attention"]
    if flash != prefills * n_attn:
        fail(f"{label}: prefill did not run the flash kernel once per "
             f"attention layer: {flash} for {prefills} x {n_attn}")
    if cfg.mla is not None:
        if dec:
            fail(f"{label}: MLA decode ran the decode kernel")
        dec_note = ("decode 0 (MLA decodes through latent matrix products, "
                    "no decode kernel)")
    else:
        if steps <= 0 or dec != steps * n_attn:
            fail(f"{label}: decode did not run the decode kernel once per "
                 f"attention layer a step: {dec} for {steps} x {n_attn}")
        dec_note = f"decode {dec} = {steps} steps x {n_attn} attention layers"
    probe = torch.tensor([done[0].prompt], device=DEVICE)
    logits, _ = forward(eng.params, {"tokens": probe}, cfg=cfg, mode="train")
    if logits.shape != (1, probe.shape[1], cfg.vocab_size) \
            or not bool(torch.isfinite(logits).all()):
        fail(f"{label}: logits are not finite or of the wrong shape")
    del logits
    prompts = [r.prompt for r in done]
    warm = warm_engine_run(eng, prompts, profile)
    readings = dict(arch=arch, flags=flags, requests=n_done, tokens=toks,
                    cold_s=secs, cold_tok_per_s=toks / secs,
                    warm_s=warm["seconds"], warm_tok_per_s=warm["tok_per_s"],
                    warm_steps=warm["steps"],
                    ms_per_step=warm["ms_per_step"], prefills=prefills,
                    decode_steps=steps, flash=flash, decode=dec,
                    generated=sorted_tokens(done[:n_done]))
    traced = ""
    if trace_steps:
        readings.update(traced_steps(eng, prompts, 16, trace_steps))
        traced = (f", {readings['launches_per_step']:.0f} host launches a "
                  f"traced decode step ({readings['traced_ms_per_step']:.2f}"
                  f" ms, device {100 * readings['busy_share']:.1f}% busy)")
    readings["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    cut = (f", n_layers cut to {layers} of {get_config(arch).n_layers} "
           f"(dataclasses.replace)" if n_layers is not None else "")
    print(f"{label} engine (bf16, full width{cut}): {n_done} requests, "
          f"{toks} tokens, cold {secs:.2f} s ({toks / secs:.1f} tok/s), "
          f"warm {warm['seconds']:.3f} s ({warm['tok_per_s']:.1f} tok/s, "
          f"{warm['steps']} steps, {warm['ms_per_step']:.2f} ms/step){traced}"
          f" on {card}; flash {flash} = {prefills} prefills x {n_attn} "
          f"attention layers (of {layers}), {dec_note}; peak memory "
          f"{readings['peak_gib']:.1f} GiB", flush=True)
    return eng, readings


def whisper_tokens(params, cfg, frames, steps: int):
    """Greedy tokens of len(frames) requests at the model level: each
    prompt (lengths WHISPER_PROMPTS, cut to the frames' count) prefilled
    alone with its frames, then `steps` decode steps of all rows."""
    from repro_torch.models.model import greedy_generate
    prompts = [[(7 * i + 3 * j + 1) % cfg.vocab_size for j in range(n)]
               for i, n in enumerate(WHISPER_PROMPTS[:len(frames)])]
    return greedy_generate(params, prompts, cfg=cfg, steps=steps, max_seq=64,
                           extras={"audio_frames": frames})


def small_train(arch: str, device: str, microbatches: int):
    """Three AdamW steps of a reduced float32 `arch` from seed-0 weights on
    seeded batches. Returns (losses, gradient norms, parameters on the
    CPU)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import dummy_batch, init_params
    from repro_torch.training import (
        AdamWConfig, init_opt_state, make_train_step,
    )
    from repro_torch.training.optimizer import leaves
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    params = _to(init_params(cfg, seed=0, device="cpu"), device)
    gen = torch.Generator().manual_seed(2)
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1),
                           microbatches=microbatches)
    state = init_opt_state(params)
    losses, norms = [], []
    for _ in range(3):
        batch = _to(dummy_batch(gen, cfg, 2, 32), device)
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, [t.cpu() for t in leaves(params)]


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def profile_train_step(cfg, params, opt_state, card: str) -> None:
    """One more full-width train step traced with torch.profiler: the device
    time by kernel, the device time of the step's two ranges (gradients,
    AdamW), and the device's busy share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import dummy_batch
    from repro_torch.training import AdamWConfig, make_train_step
    step = make_train_step(cfg, AdamWConfig(lr=1e-4, warmup_steps=1))
    batch = dummy_batch(torch.Generator(device=params["embed"].device)
                        .manual_seed(5), cfg, 4, 256)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, opt_state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=25))
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e.time_range for e in events if e.device_type == cuda
               and not e.name.startswith("train_step.")]
    busy = sum(k.elapsed_us() for k in kernels)
    parts = []
    for name in ("train_step.grads", "train_step.adamw"):
        r = next(e.time_range for e in events
                 if e.name == name and e.device_type != cuda)
        inside = sum(k.elapsed_us() for k in kernels
                     if r.start <= k.start <= r.end)
        parts.append(f"{name} {inside / 1e3:.1f} ms of device time, "
                     f"{r.elapsed_us() / 1e3:.1f} ms on the host")
    launches = sum(e.count for e in prof.key_averages()
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernelEx"))
    print(f"traced {cfg.arch_id} train step on {card}: wall "
          f"{wall * 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms "
          f"({100 * busy / 1e6 / wall:.1f}%), {launches} kernel launches; "
          + "; ".join(parts), flush=True)


def run_whisper_and_training(run_path, paths, card: str, dev,
                             profile: bool) -> None:
    """Phase 10 (see the module's docstring)."""
    import dataclasses
    import math
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_launcher
    from repro_torch.models import dummy_batch, forward, init_params
    from repro_torch.training import (
        AdamWConfig, init_opt_state, make_train_step,
    )

    # full-width whisper-base, bf16
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("whisper-base")
    params = init_params(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    frames = torch.randn(len(WHISPER_PROMPTS), cfg.encoder_seq_len,
                         cfg.d_model, generator=gen, device=dev).to(
                             torch.bfloat16)
    t0 = time.perf_counter()
    toks = run_path("whisper-base", lambda: whisper_tokens(
        params, cfg, frames, WHISPER_STEPS))
    secs = time.perf_counter() - t0
    launches = paths["whisper-base"]
    n, n_enc, n_req = cfg.n_layers, cfg.n_encoder_layers, len(toks)
    want_flash = n_req * (n_enc + 2 * n) + WHISPER_STEPS * n
    if [len(t) for t in toks] != [WHISPER_STEPS + 1] * n_req \
            or any(not 0 <= t < cfg.vocab_size for r in toks for t in r):
        fail("whisper-base: not every request got its tokens")
    if launches["flash_attention"] != want_flash \
            or launches["decode_attention"] != WHISPER_STEPS * n:
        fail(f"whisper-base: launches {launches}, expected flash "
             f"{want_flash} and decode {WHISPER_STEPS * n}")
    logits, _ = forward(params, {"tokens": torch.tensor(
        [[5, 6, 7]], device=dev), "audio_frames": frames[:1]}, cfg=cfg)
    if logits.shape != (1, 3, cfg.vocab_size) \
            or not bool(torch.isfinite(logits).all()):
        fail("whisper-base: logits are not finite or of the wrong shape")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    whisper_tokens(params, cfg, frames, WHISPER_STEPS)
    warm = time.perf_counter() - t0
    n_tok = n_req * (WHISPER_STEPS + 1)
    print(f"whisper-base (bf16, full width, model level): {n_req} requests "
          f"of {list(WHISPER_PROMPTS)} tokens with {cfg.encoder_seq_len} "
          f"frames each, {n_tok} tokens; cold {secs:.3f} s, warm "
          f"{warm:.3f} s ({n_tok / warm:.1f} tok/s) on {card}; flash "
          f"{launches['flash_attention']} = {n_req} prefills x ({n_enc} "
          f"encoder + {n} self + {n} cross) + {WHISPER_STEPS} steps x {n} "
          f"cross, decode {launches['decode_attention']} = {WHISPER_STEPS} "
          f"x {n}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB", flush=True)
    del params, frames, logits
    torch.cuda.empty_cache()

    rcfg = dataclasses.replace(cfg.reduced(), dtype="float32")
    rparams = init_params(rcfg, seed=0, device="cpu")
    rframes = torch.randn(3, rcfg.encoder_seq_len, rcfg.d_model,
                          generator=torch.Generator().manual_seed(1))
    on_card = run_path("reduced whisper-base", lambda: whisper_tokens(
        _to(rparams, dev), rcfg, rframes.to(dev), 8))
    on_cpu = whisper_tokens(rparams, rcfg, rframes, 8)
    print(f"reduced f32 whisper-base, card vs CPU plain path: "
          f"{'same' if on_card == on_cpu else 'DIFFERENT'} greedy tokens; "
          f"launches on the card {paths['reduced whisper-base']}", flush=True)
    if on_card != on_cpu:
        fail(f"whisper-base: greedy tokens differ: card {on_card} "
             f"cpu {on_cpu}")

    # full-width gemma-2b trained through the launcher
    torch.cuda.reset_peak_memory_stats()
    tcfg, tparams, topt, hist = run_path(
        "train gemma-2b", lambda: train_launcher.main(TRAIN_ARGS))
    flash = paths["train gemma-2b"]["flash_attention"]
    steps, batch, seq = (int(TRAIN_ARGS[TRAIN_ARGS.index(f) + 1])
                         for f in ("--steps", "--batch", "--seq"))
    losses = [h["loss"] for h in hist]
    norms = [h["grad_norm"] for h in hist]
    if len(hist) != steps or not all(map(math.isfinite, losses + norms)):
        fail(f"gemma-2b training: losses {losses}, grad norms {norms}")
    if abs(losses[0] - math.log(tcfg.vocab_size)) > 1.5:
        fail(f"gemma-2b training: step-0 loss {losses[0]:.3f}, not within "
             f"1.5 of ln V = {math.log(tcfg.vocab_size):.3f}")
    if not all(float(layer["norm1"]["scale"].abs().sum()) > 0
               for layer in tparams["layers"]):
        fail("gemma-2b training: the parameters did not move")
    n_attn = tcfg.attention_layer_count()
    if flash != steps * n_attn:
        fail(f"gemma-2b training: flash {flash}, expected {steps} steps x "
             f"{n_attn} layers")
    step_s = (hist[-1]["elapsed_s"] - hist[0]["elapsed_s"]) / (steps - 1)
    print(f"gemma-2b training (bf16, full width, {tcfg.param_count() / 1e9:.2f}"
          f" B params, batch {batch} x {seq}): losses "
          f"{[round(x, 4) for x in losses]}, grad norms "
          f"{[round(x, 3) for x in norms]}; {1e3 * step_s:.1f} ms a step "
          f"(steps 1-{steps - 1}; step 0 {1e3 * hist[0]['elapsed_s']:.1f} "
          f"ms), {batch * seq / step_s:.0f} tokens/s on {card}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; flash "
          f"{flash} = {steps} steps x {n_attn} layers", flush=True)
    if profile:
        profile_train_step(tcfg, tparams, topt, card)
    del tparams, topt, hist
    torch.cuda.empty_cache()

    # one train step of full-width whisper-base
    def whisper_step():
        p = init_params(cfg, seed=0, device=dev)
        data = dummy_batch(torch.Generator(device=dev).manual_seed(3), cfg, 4,
                           256)
        step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1))
        _, _, m = step(p, init_opt_state(p), data)
        return {k: float(v) for k, v in m.items()}

    m = run_path("train whisper-base", whisper_step)
    wl = paths["train whisper-base"]
    if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])) \
            or wl["flash_attention"] != n_enc + 2 * n:
        fail(f"whisper-base training: metrics {m}, launches {wl}")
    print(f"whisper-base train step (bf16, full width, batch 4 x 256 tokens, "
          f"256 frames): loss {m['loss']:.4f}, grad norm "
          f"{m['grad_norm']:.3f}; flash {wl['flash_attention']} = {n_enc} "
          f"encoder + {n} self + {n} cross", flush=True)
    torch.cuda.empty_cache()

    # three reduced float32 train steps of each family, card against CPU
    for arch in TRAIN_ARCHS:
        for mb in (1, 2):
            label = f"train reduced {arch} mb{mb}"
            card_l, card_n, card_p = run_path(
                label, lambda arch=arch, mb=mb: small_train(arch, DEVICE, mb))
            cpu_l, cpu_n, cpu_p = small_train(arch, "cpu", mb)
            worst = max((a - b).abs().max().item()
                        for a, b in zip(card_p, cpu_p, strict=True))
            dl = max(abs(a - b) for a, b in zip(card_l, cpu_l, strict=True))
            kernel = "ssd_diag" if arch.startswith("mamba2") \
                else "flash_attention"
            print(f"reduced f32 {arch} training, {mb} microbatch(es), card vs "
                  f"CPU: losses {[round(x, 5) for x in card_l]} (max diff "
                  f"{dl:.2e}), params max diff {worst:.2e}; launches "
                  f"{paths[label]}", flush=True)
            if dl > 1e-4 or worst > 5e-3 \
                    or not all(map(math.isfinite, card_l + card_n)):
                fail(f"{label}: card and CPU disagree")
            if paths[label][kernel] <= 0:
                fail(f"{label}: the {kernel} kernel did not run")


# ---------------------------------------------------------------------------
# phase 11: the sharded paths, 4 ranks on the one card
# ---------------------------------------------------------------------------


def _shard_prompts(vocab: int):
    """Phase 4's 8 prompts (the launcher's draw)."""
    import numpy as np
    rng = np.random.default_rng(0)
    lo, hi = SHARD_SERVE["prompt_len"]
    out = []
    for _ in range(SHARD_SERVE["requests"]):
        plen = int(rng.integers(lo, hi))
        out.append([int(t) for t in rng.integers(0, vocab, plen)])
    return out


def _cfg(arch, **kw):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return dataclasses.replace(cfg, **kw) if kw else cfg


def _cp_inputs(vocab):
    import torch
    gen = torch.Generator().manual_seed(11)
    return torch.randint(0, vocab, (CP_ROWS, CP_PROMPT + 1), generator=gen)


def _moe_inputs(vocab):
    import torch
    gen = torch.Generator().manual_seed(12)
    return torch.randint(0, vocab, (MOE_ROWS, MOE_PROMPT + 1), generator=gen)


def _train_batch(vocab):
    import torch
    gen = torch.Generator().manual_seed(13)
    return {k: torch.randint(0, vocab, (4, 256), generator=gen)
            for k in ("tokens", "labels")}


def _prefill_decode(params, cfg, toks, slots, ctx=None, extras=None):
    """Prefill all but the last token (with the batch's `extras`, such as
    whisper's frames, in the model's dtype), then one scalar-`pos` decode
    step: (last prefill logits, decode logits) on the CPU, float32."""
    import torch
    from repro_torch.models import decode_step, init_cache, prefill
    dev = params["embed"].device
    s = toks.shape[1] - 1
    cache = init_cache(cfg, toks.shape[0], slots, device=dev, ctx=ctx)
    batch = {"tokens": toks[:, :s].to(dev)}
    batch.update({k: v.to(dev, params["embed"].dtype)
                  for k, v in (extras or {}).items()})
    last, cache = prefill(params, batch, cache, cfg=cfg, ctx=ctx)
    dec, _ = decode_step(params, toks[:, s:].to(dev), cache, s, cfg=cfg,
                         ctx=ctx)
    return last.float().cpu(), dec.float().cpu()


def _small_sharded_tokens(arch, device, ctx=None):
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.training.optimizer import tree_map
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    # the CPU generator's draw, wherever the engine runs
    params = tree_map(lambda t: t.to(device),
                      init_params(cfg, seed=0, device="cpu", ctx=ctx))
    eng = ServingEngine(cfg, params, max_batch=4, max_seq=64, device=device,
                        ctx=ctx)
    reqs = [eng.submit(p, max_new_tokens=8) for p in SHARD_SMALL_PROMPTS]
    eng.run_until_idle()
    out = [list(r.generated) for r in reqs]
    del eng, params
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def _single_and_f32(cfg, dev, toks, slots, extras=None):
    """One rank's bf16 run and the same weights' float32 run."""
    import dataclasses
    import torch
    from repro_torch.models import init_params
    from repro_torch.training.optimizer import tree_map
    params = init_params(cfg, seed=0, device=dev)
    single = _prefill_decode(params, cfg, toks, slots, extras=extras)
    params = tree_map(lambda t: t.float(), params)
    f32 = _prefill_decode(params, dataclasses.replace(cfg, dtype="float32"),
                          toks, slots, extras=extras)
    del params
    torch.cuda.empty_cache()
    return single, f32


def _whisper_inputs(cfg):
    """SHARD_WHISPER's prompt rows (and the decode token) and their 1500
    frames, float32 on the CPU."""
    import torch
    gen = torch.Generator().manual_seed(15)
    w = SHARD_WHISPER
    toks = torch.randint(0, cfg.vocab_size, (w["rows"], w["prompt"] + 1),
                         generator=gen)
    frames = torch.randn((w["rows"], cfg.encoder_seq_len, cfg.d_model),
                         generator=gen)
    return toks, {"audio_frames": frames}


def _mixer_weight_bytes(cfg) -> int:
    """Bytes of the smallest whole column- or row-parallel weight of a
    Mamba-2, RG-LRU or MLA mixer in `cfg` (0 if it has none): a decode
    step's all-gathers must stay below it."""
    from repro_torch.models import params_shapes
    from repro_torch.models.transformer import block_program
    names = {"ssm": ("wz", "wx", "out_proj"),
             "rec": ("w_gate_in", "w_rec_in", "out_proj"),
             "mla": ("wq_b", "wkv_b", "wo")}
    sizes = [p["mix"][n].numel() * p["mix"][n].element_size()
             for spec, p in zip(block_program(cfg).layers(),
                                params_shapes(cfg)["layers"], strict=True)
             for n in names.get(spec.kind, ())]
    return min(sizes, default=0)


def _moe_layer_input(d_model):
    import torch
    gen = torch.Generator().manual_seed(14)
    return torch.randn((MOE_ROWS, MOE_PROMPT, d_model), generator=gen)


def _rel(got, want) -> float:
    """Max error over the RMS of `want`."""
    return ((got - want).abs().max() / want.pow(2).mean().sqrt()).item()


def _single_train(cfg, dev, batch):
    """One rank's train step: its loss, gradient norm and update norm, and
    the last layer's updated weights and first moments (on the CPU)."""
    import torch
    from repro_torch.models import init_params
    from repro_torch.training import (AdamWConfig, init_opt_state,
                                      make_train_step)
    from repro_torch.training.optimizer import leaves, tree_map
    params = init_params(cfg, seed=0, device=dev)
    old = tree_map(lambda t: t.clone(), params)
    step = make_train_step(cfg, AdamWConfig(**SHARD_ADAMW))
    params, opt, m = step(params, init_opt_state(params),
                          {k: v.to(dev) for k, v in batch.items()})
    sq = sum((a.float() - b.float()).square().sum()
             for a, b in zip(leaves(params), leaves(old), strict=True))
    out = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "update_norm": sq.sqrt().item(),
           "last": {"p": tree_map(lambda t: t.cpu(), params["layers"][-1]),
                    "m": tree_map(lambda t: t.cpu(), opt.m["layers"][-1])},
           "last_old": tree_map(lambda t: t.cpu(), old["layers"][-1])}
    del params, old, opt, step, m
    torch.cuda.empty_cache()
    return out


def _train_readings(got, want, last_params, last_moments):
    """A train step's readings against one rank's full-batch step."""
    return {"loss": abs(got["loss"] - want["loss"]),
            "grad_norm": abs(got["grad_norm"] / want["grad_norm"] - 1),
            "update_norm": abs(got["update_norm"] / want["update_norm"] - 1),
            "last_params": last_params, "last_moments": last_moments}


def _update(new, old) -> list:
    """new - old, leaf by leaf, in float32."""
    from repro_torch.training.optimizer import leaves
    return [a.float() - b.float()
            for a, b in zip(leaves(new), leaves(old), strict=True)]


def _tree_rel(got, want, base) -> float:
    """RMS of got - want over the RMS of base, over the leaves of a tree."""
    from repro_torch.training.optimizer import leaves
    num = sum((a.float() - b.float()).square().sum() for a, b in zip(
        leaves(got), leaves(want), strict=True))
    den = sum(b.float().square().sum() for b in leaves(base))
    return (num / den).sqrt().item()


def shard_references(dev):
    """Phase 11's single-rank runs on the card (each freed before the
    next) and the reduced engines on the CPU."""
    import dataclasses
    import torch
    from repro_torch.models import init_params
    from repro_torch.models import moe as MOE
    from repro_torch.training.optimizer import tree_map
    refs = {}
    cfg = _cfg("gemma-2b")
    refs["cp"], refs["cp_f32"] = _single_and_f32(
        cfg, dev, _cp_inputs(cfg.vocab_size), CP_SLOTS)
    # the families' logits on one rank, bf16 and float32
    refs["logits"] = {}
    for arch in SHARD_ENGINES:
        cfg = _cfg(arch)
        refs["logits"][arch] = _single_and_f32(
            cfg, dev, _cp_inputs(cfg.vocab_size), CP_SLOTS)
    cfg = _cfg("whisper-base")
    toks, extras = _whisper_inputs(cfg)
    refs["logits"]["whisper-base"] = _single_and_f32(
        cfg, dev, toks, SHARD_WHISPER["slots"], extras)
    # deepseek: one rank's bf16 and float32 runs, dense dispatch, and the
    # float32 MoE layer alone; a second draw of the weights (seed 1) is
    # the witness of the bf16 run's distance from the float32 one
    cfg = _cfg("deepseek-moe-16b", n_layers=MOE_LAYERS)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    toks = _moe_inputs(cfg.vocab_size)
    refs["moe_bf16_gap"] = {}
    for seed in (0, 1):
        params = init_params(cfg, seed=seed, device=dev)
        single = _prefill_decode(params, cfg, toks, 64)
        params = tree_map(lambda t: t.float(), params)
        f32 = _prefill_decode(params, cfg32, toks, 64)
        refs["moe_bf16_gap"][seed] = [_rel(a, b) for a, b in zip(
            single, f32, strict=True)]
        if seed == 0:
            refs["moe"], refs["moe_f32"] = single, f32
            refs["moe_layer_f32"] = MOE.moe_layer(
                params["layers"][MOE_CHECK_LAYER]["moe"],
                _moe_layer_input(cfg.d_model).to(dev), cfg=cfg32)[0].cpu()
        del params
        torch.cuda.empty_cache()
    # the train step on the whole batch, and the fault: on half of it
    cfg = _cfg("gemma-2b", n_layers=SHARD_TRAIN_LAYERS)
    batch = _train_batch(cfg.vocab_size)
    refs["train"] = _single_train(cfg, dev, batch)
    half = _single_train(cfg, dev, {k: v[:2] for k, v in batch.items()})
    want = refs["train"]
    refs["train_fault"] = _train_readings(
        half, want,
        _tree_rel(half["last"]["p"], want["last"]["p"],
                  _update(want["last"]["p"], want["last_old"])),
        _tree_rel(half["last"]["m"], want["last"]["m"], want["last"]["m"]))
    refs["small"] = {arch: _small_sharded_tokens(arch, "cpu")
                     for arch in SHARD_SMALL}
    return refs


def _rank_main(rank, world, port, args_path, out_path):
    """One rank of phase 11 (spawned; the kernels are built already)."""
    sys.path.insert(0, str(ROOT / "src"))
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import _build, ops
    from repro_torch.models import init_params
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    from repro_torch.models import parallel as PAR
    from repro_torch.models.transformer import block_program
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.training import (AdamWConfig, init_opt_state_sharded,
                                      make_train_step)
    from repro_torch.training.optimizer import leaves, tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(DEVICE)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.set_device(0)
        _build.load_library()
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    mesh = PAR.init_mesh(SHARD_MESH, ("data", "model"), backend="gloo")
    ctx = PAR.ParallelContext(mesh=mesh)
    res = {"paths": {}, "peak_gib": {}, "stages": {}}
    t_stage = [time.perf_counter()]
    # the largest float32 all-gather of a path, in elements (a bf16
    # model's logits are its large float32 tensors), and its 3-D
    # reduce-scatters by element count (SP's residual slices)
    f32_gather, scatters, count = [0], {}, PAR._count

    def counted(kind, out):
        if kind == "all-gather" and out.dtype == torch.float32:
            f32_gather[0] = max(f32_gather[0], out.numel())
        if kind == "reduce-scatter" and out.dim() == 3:
            scatters[out.numel()] = scatters.get(out.numel(), 0) + 1
        count(kind, out)
    PAR._count = counted

    def stage(name):
        now = time.perf_counter()
        res["stages"][name] = now - t_stage[0]
        t_stage[0] = now
    stage("start")

    def path(label, fn):
        """Counts to 0 just before the run, read just after."""
        ops.reset_launches()
        PAR.reset_collectives()
        f32_gather[0] = 0
        scatters.clear()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        t0 = time.perf_counter()
        out = fn()
        if on_card:
            torch.cuda.synchronize()
        dist.barrier()
        res["paths"][label] = dict(
            launches=ops.kernel_launches(), seconds=time.perf_counter() - t0,
            collectives=PAR.collective_counts(), f32_gather=f32_gather[0],
            scatters=dict(scatters))
        res["peak_gib"][label] = (torch.cuda.max_memory_allocated() / 2 ** 30
                                  if on_card else 0.0)
        return out

    def serve_engine(arch, cfg, params):
        """Phase 4's requests on the sharded engine: cold (counted), warm
        (timed), then once more for SHARD_TRACED_STEPS decode steps traced
        on rank 0 (host launches a step, the device's busy share) and
        counted (collectives a decode step, by kind); the engine is dropped
        with that run unfinished."""
        prompts = _shard_prompts(cfg.vocab_size)

        def serve():
            eng = ServingEngine(cfg, params,
                                max_batch=SHARD_SERVE["max_batch"],
                                max_seq=SHARD_SERVE["max_seq"], device=dev,
                                ctx=ctx)
            for p in prompts:
                eng.submit(p, max_new_tokens=SHARD_SERVE["max_new"])
            eng.run_until_idle()
            return eng
        eng = path(f"11 {arch} sharded engine", serve)
        done = list(eng.completed)
        out = dict(
            requests=len(done), tokens=sum(len(r.generated) for r in done),
            in_vocab=all(0 <= t < cfg.vocab_size for r in done
                         for t in r.generated),
            decode_steps=eng.n_decode_steps, prefills=eng.n_prefills)
        stage(f"{arch} engine")
        for p in prompts:
            eng.submit(p, max_new_tokens=SHARD_SERVE["max_new"])
        if on_card:
            torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        steps = 0
        while eng.queue or eng.active_slots:
            eng.step()
            steps += 1
        if on_card:
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        toks = sum(len(r.generated) for r in eng.completed[len(done):])
        out.update(warm_tokens=toks, warm_s=secs, warm_steps=steps,
                   warm_tok_per_s=toks / secs)
        stage(f"{arch} warm")
        for p in prompts:
            eng.submit(p, max_new_tokens=SHARD_SERVE["max_new"])
        for _ in range(2):          # admit and prefill first
            eng.step()
        prof = None
        if rank == 0 and on_card:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
            torch.cuda.synchronize()
        PAR.reset_collectives()
        t0 = time.perf_counter()
        for _ in range(SHARD_TRACED_STEPS):
            eng.step()
        if on_card:
            torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
        out["step_collectives"] = {
            k: {"calls": v["calls"] / SHARD_TRACED_STEPS,
                "bytes": v["bytes"] / SHARD_TRACED_STEPS,
                "largest": v["largest"]}
            for k, v in PAR.collective_counts().items()}
        out["step_s"] = traced_s / SHARD_TRACED_STEPS
        if prof is not None:
            prof.__exit__(None, None, None)
            avg = prof.key_averages()
            out["host_launches_per_step"] = sum(
                e.count for e in avg if e.key in ("cudaLaunchKernel",
                                                  "cuLaunchKernelEx")
            ) / SHARD_TRACED_STEPS
            cuda = torch.autograd.DeviceType.CUDA
            out["busy_share"] = sum(
                e.self_device_time_total for e in avg
                if e.device_type == cuda) / 1e6 / traced_s
        stage(f"{arch} traced")
        return out

    # full-width gemma-2b: CP prefill + decode, the sharded engine, then the
    # sharded paged engine
    cfg = _cfg("gemma-2b")
    params = init_params(cfg, seed=0, device=dev, ctx=ctx)
    stage("gemma-2b init")
    res["cp"] = path("11 gemma-2b CP decode", lambda: _prefill_decode(
        params, cfg, _cp_inputs(cfg.vocab_size), CP_SLOTS, ctx))
    res["engines"] = {"gemma-2b": serve_engine("gemma-2b", cfg, params)}

    def paged():
        head = [(11 * j + 3) % cfg.vocab_size for j in range(32)]
        prompts = [head + [7, 8, 9, 10, 11], head + [20, 21, 22],
                   [4, 5, 6, 7, 8, 9]]
        eng = ServingEngine(cfg, params, max_batch=SHARD_SERVE["max_batch"],
                            max_seq=SHARD_SERVE["max_seq"], device=dev,
                            ctx=ctx, paged=True, kv_block_tokens=16)
        toks = evict_resume(eng, prompts, SHARD_PAGED_NEW)
        dense = ServingEngine(cfg, params,
                              max_batch=SHARD_SERVE["max_batch"],
                              max_seq=SHARD_SERVE["max_seq"], device=dev,
                              ctx=ctx)
        want = [dense.submit(p, max_new_tokens=SHARD_PAGED_NEW)
                for p in prompts]
        dense.run_until_idle()
        return dict(tokens=toks, dense=[r.generated for r in want],
                    hits=eng.n_prefix_hits, prefills=eng.n_prefills,
                    returned=eng.kv.free_blocks == eng.kv.n_blocks)
    res["paged"] = path("11 gemma-2b sharded paged engine", paged)
    stage("gemma-2b paged")
    del params
    if on_card:
        torch.cuda.empty_cache()

    # the Mamba-2, RG-LRU, MLA and M-RoPE families at full width: logits,
    # then the engine; the paged kernel on a rank's qwen2-vl pool
    res["logits"] = {}
    for arch in SHARD_ENGINES:
        cfg = _cfg(arch)
        params = init_params(cfg, seed=0, device=dev, ctx=ctx)
        stage(f"{arch} init")
        res["logits"][arch] = path(
            f"11 {arch} sharded logits", lambda: _prefill_decode(
                params, cfg, _cp_inputs(cfg.vocab_size), CP_SLOTS, ctx))
        res["engines"][arch] = serve_engine(arch, cfg, params)
        res["engines"][arch]["mixer_weight_bytes"] = _mixer_weight_bytes(cfg)
        if arch == "qwen2-vl-2b":
            pool, outs = path(f"11 {arch} paged pool",
                              lambda: paged_pool_check(params, cfg, ctx))
            decode_yardstick(pool, outs)
            res["pool"] = pool
            del outs
        del params
        if on_card:
            torch.cuda.empty_cache()
        stage(f"{arch} done")

    # whisper-base at the model level
    cfg = _cfg("whisper-base")
    params = init_params(cfg, seed=0, device=dev, ctx=ctx)
    toks, extras = _whisper_inputs(cfg)
    res["logits"]["whisper-base"] = path(
        "11 whisper-base sharded", lambda: _prefill_decode(
            params, cfg, toks, SHARD_WHISPER["slots"], ctx, extras))
    del params
    if on_card:
        torch.cuda.empty_cache()
    stage("whisper-base")

    # deepseek-moe-16b: ep_a2a and the constraint form through the model
    # in bf16; then, on the same weights in float32, the constraint form
    # through the model and the ep_a2a layer alone at capacity MOE_CAPACITY
    cfg = _cfg("deepseek-moe-16b", n_layers=MOE_LAYERS)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = init_params(cfg, seed=0, device=dev, ctx=ctx)
    stage("deepseek init")
    toks = _moe_inputs(cfg.vocab_size)
    res["moe"] = {}
    res["moe_layers"] = sum(s.moe for s in block_program(cfg).layers())
    ep = dataclasses.replace(ctx, moe_expert_parallel=True)
    for label, c in (("ep_a2a", dataclasses.replace(
            ctx, moe_dispatch="ep_a2a")), ("expert_parallel", ep)):
        res["moe"][label] = path(f"11 deepseek-moe-16b {label}",
                                 lambda c=c: _prefill_decode(
                                     params, cfg, toks, 64, c))
    params = tree_map(lambda t: t.float(), params)
    res["moe"]["expert_parallel_f32"] = path(
        "11 deepseek-moe-16b expert_parallel f32",
        lambda: _prefill_decode(params, cfg32, toks, 64, ep))
    x = ctx.shard_batch(_moe_layer_input(cfg.d_model)).to(dev)
    out, _ = path("11 deepseek-moe-16b ep_a2a layer f32",
                  lambda: MOE.moe_layer_ep_a2a(
                      params["layers"][MOE_CHECK_LAYER]["moe"], x, cfg=cfg32,
                      ctx=ctx, capacity_factor=MOE_CAPACITY))
    res["moe"]["ep_a2a_layer_f32"] = PAR.all_gather(
        out, ctx, ctx.batch_spec, 0).cpu()
    del params, x, out
    if on_card:
        torch.cuda.empty_cache()
    stage("deepseek runs")

    # the sharded train step of full-width gemma-2b
    cfg = _cfg("gemma-2b", n_layers=SHARD_TRAIN_LAYERS)
    params = init_params(cfg, seed=0, device=dev, ctx=ctx)
    opt = init_opt_state_sharded(params, cfg, ctx)
    old = tree_map(lambda t: t.clone(), params)
    stage("train init")
    res["moment_bytes"] = sum(t.numel() * 4 for t in leaves(opt.m)) * 2
    step = make_train_step(cfg, AdamWConfig(**SHARD_ADAMW), ctx=ctx)
    batch = {k: v.to(dev) for k, v in _train_batch(cfg.vocab_size).items()}
    params, opt, m = path("11 gemma-2b sharded train step",
                          lambda: step(params, opt, batch))
    res["train"] = {k: float(v) for k, v in m.items()}
    # the update's norm over the model: each shard's squares once
    shapes = M.params_shapes(cfg)
    specs = PAR.param_specs(shapes, ctx)

    def held_once(new, before, spec):
        held = math.prod(ctx.axis_size(e) for e in spec if e is not None)
        return (new.float() - before.float()).square().sum() * held / world
    sq = sum(leaves(PAR.map_trees(held_once, params, old, specs)))
    dist.all_reduce(sq)
    res["train"]["update_norm"] = sq.sqrt().item()
    # the last layer's weights and first moments against one rank's, each
    # rank on the part it holds
    want = torch.load(args_path, weights_only=False)
    local_p = PAR.shard_tree(want["p"], specs["layers"][-1], ctx)
    local_m = PAR.shard_tree(
        want["m"], PAR.opt_state_shardings(shapes, ctx)["layers"][-1], ctx)
    local_old = old["layers"][-1]
    worst = torch.tensor([
        _tree_rel(params["layers"][-1], tree_map(lambda t: t.to(dev),
                                                 local_p),
                  _update(tree_map(lambda t: t.to(dev), local_p),
                          local_old)),
        _tree_rel(opt.m["layers"][-1], tree_map(lambda t: t.to(dev),
                                                local_m),
                  tree_map(lambda t: t.to(dev), local_m))])
    dist.all_reduce(worst, op=dist.ReduceOp.MAX)
    res["train"]["last_params"], res["train"]["last_moments"] = \
        worst.tolist()
    del params, old, opt, step, m, want, local_p, local_m, local_old
    if on_card:
        torch.cuda.empty_cache()
    stage("train step")

    # reduced float32 engines, sharded on the card
    res["small"] = {}
    for arch in SHARD_SMALL:
        c = ep if arch == "deepseek-moe-16b" else ctx
        res["small"][arch] = path(
            f"11 reduced {arch} engine",
            lambda arch=arch, c=c: _small_sharded_tokens(arch, dev, c))
    stage("reduced engines")
    res["backend"] = dist.get_backend()
    peaks = [None] * world
    dist.all_gather_object(peaks, res["peak_gib"])
    res["peak_gib_by_rank"] = peaks
    if rank == 0:
        torch.save(res, out_path)
    dist.barrier()
    dist.destroy_process_group()


def shard_close(label, shard, single, f32) -> bool:
    """A sharded bf16 run's logits against one rank's: the `close` gate
    between them is printed; the run passes if its error against the
    float32 model is within REL_RMS of that model's RMS or at most
    SHARD_VS_F32 times one rank's bf16 error against it."""
    err, rel, ok = close(shard, single, "bfloat16")
    rms = f32.pow(2).mean().sqrt().item()
    e_shard = (shard - f32).abs().max().item() / rms
    e_single = (single - f32).abs().max().item() / rms
    good = e_shard <= max(REL_RMS, SHARD_VS_F32 * e_single)
    print(f"{label} logits: vs one rank err {err:.3e} ({100 * rel:.2f}% "
          f"rms, close gate {'ok' if ok else 'beyond'}); against the float32 "
          f"model sharded {100 * e_shard:.2f}%, one rank {100 * e_single:.2f}% "
          f"of its rms {'ok' if good else 'MISMATCH'}", flush=True)
    return good


def head_gathers(res) -> None:
    """The vocabulary-parallel head on the card: gemma-2b's sharded train
    step (its loss all-reduces each row's max, sum and gold logit) gathers
    no float32 logits, and the CP path's prefill and decode gather one row
    a sequence, not every position's; each path's all-gather bytes and
    peak a rank are printed."""
    vocab = _cfg("gemma-2b").vocab_size
    rows = [_train_batch(vocab)["tokens"].shape, (CP_ROWS, CP_PROMPT)]
    for (b, s), label in zip(rows, ("11 gemma-2b sharded train step",
                                    "11 gemma-2b CP decode"), strict=True):
        p = res["paths"][label]
        ag = p["collectives"]["all-gather"]
        most = p["f32_gather"] // vocab
        peaks = [f"{r[label]:.2f}" for r in res["peak_gib_by_rank"]]
        print(f"sharded head, {label[3:]}: all-gather {ag['calls']} calls, "
              f"{ag['bytes'] / 2 ** 30:.4f} GiB; float32 rows of logits "
              f"gathered at most {most} at once ({b} sequences, a head "
              f"over every position {b // SHARD_MESH[0] * s}); peak GiB by "
              f"rank {peaks}", flush=True)
        if most > b:
            fail(f"{label} gathers float32 logits over every position")


def seq_parallel_readings(res) -> None:
    """Sequence parallelism on the card: each sharded path's peak a rank
    and its all-gathers, reduce-scatters and all-reduces (calls, GiB,
    largest MiB); the train step (sequence 256) and the CP path's prefill
    (64) split the residual over the model axis, so each reduce-scatters
    at least two partials a layer to a residual slice (B_local, S/m, D),
    after the mixer and after the MLP (ZeRO-1's gradient reduce-scatters
    are not counted there), and all-reduces none as large as a whole
    (B_local, S, D) float32 one."""
    cfg = _cfg("gemma-2b")
    b_local = _train_batch(cfg.vocab_size)["tokens"].shape[0] \
        // SHARD_MESH[0]
    held = {"11 gemma-2b sharded train step": (b_local, 256,
                                               SHARD_TRAIN_LAYERS),
            "11 gemma-2b CP decode": (CP_ROWS // SHARD_MESH[0], CP_PROMPT,
                                      cfg.n_layers)}
    for label, p in res["paths"].items():
        if not (label in held or label.endswith("engine")):
            continue
        c = p["collectives"]
        kinds = ", ".join(
            f"{k} {c[k]['calls']} ({c[k]['bytes'] / 2 ** 30:.3f} GiB, "
            f"largest {c[k]['largest'] / 2 ** 20:.2f} MiB)"
            for k in ("all-gather", "reduce-scatter", "all-reduce"))
        peaks = [f"{r[label]:.2f}" for r in res["peak_gib_by_rank"]]
        print(f"sequence parallelism, {label[3:]}: {kinds}; peak GiB by "
              f"rank {peaks}", flush=True)
        if label not in held:
            continue
        b, s, layers = held[label]
        partial = b * s * cfg.d_model * 4
        residual = p["scatters"].get(b * s // SHARD_MESH[1] * cfg.d_model, 0)
        print(f"sequence parallelism, {label[3:]}: {residual} "
              f"reduce-scatters to a residual slice ({layers} layers)",
              flush=True)
        if residual < 2 * layers or c["all-reduce"]["largest"] >= partial:
            fail(f"{label} does not split the residual over the sequence: "
                 f"{c}")


def run_sharded(paths, card: str, dev) -> None:
    """Phase 11 (see the module's docstring)."""
    import socket
    import tempfile
    import torch
    import torch.multiprocessing as mp
    t0 = time.time()
    refs = shard_references(dev)
    torch.cuda.empty_cache()
    print(f"sharded: single-rank references in {time.time() - t0:.1f} s",
          flush=True)
    world = SHARD_MESH[0] * SHARD_MESH[1]
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    with tempfile.TemporaryDirectory() as d:
        out_path = str(Path(d) / "rank0.pt")
        want_path = str(Path(d) / "train_last_layer.pt")
        torch.save(refs["train"]["last"], want_path)
        t0 = time.time()
        mp.spawn(_rank_main, args=(world, port, want_path, out_path),
                 nprocs=world, join=True)
        spawn_s = time.time() - t0
        res = torch.load(out_path, weights_only=False)
    print(f"sharded: {world} ranks on {card}, mesh {SHARD_MESH} (data, "
          f"model), backend {res['backend']}, {spawn_s:.1f} s", flush=True)
    print("  rank 0's stages (s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in res["stages"].items()), flush=True)
    for label, p in res["paths"].items():
        paths[label] = p["launches"]
        coll = {k: (v["calls"], v["bytes"]) for k, v in
                p["collectives"].items() if v["calls"]}
        peaks = [f"{r[label]:.2f}" for r in res["peak_gib_by_rank"]]
        print(f"  {label}: {p['seconds']:.2f} s, launches {p['launches']}, "
              f"collectives (calls, bytes) {coll}, peak GiB by rank "
              f"{peaks}", flush=True)

    # gemma-2b CP decode against the single rank
    for i, what in enumerate(("prefill", "CP decode")):
        if not shard_close(f"sharded gemma-2b {what}", res["cp"][i],
                           refs["cp"][i], refs["cp_f32"][i]):
            fail(f"sharded gemma-2b {what} logits differ from one rank's")
    cp = res["paths"]["11 gemma-2b CP decode"]["launches"]
    if cp["decode_attention_lse"] < 1 or cp["flash_attention"] < 1:
        fail("the CP decode did not run the decode kernel with lse and "
             "the flash kernel")
    # the sharded engines: every request finished, the kernels the family
    # decodes with, no mixer weight gathered on a decode step
    want_kernels = {
        "gemma-2b": ("flash_attention", "decode_attention_lse"),
        "mamba2-2.7b": ("ssd_diag",),
        "recurrentgemma-2b": ("flash_attention", "decode_attention_lse"),
        "minicpm3-4b": ("flash_attention",),
        "qwen2-vl-2b": ("flash_attention", "decode_attention")}
    n = SHARD_SERVE["requests"]
    for arch, e in res["engines"].items():
        label = f"11 {arch} sharded engine"
        coll = {k: (round(v["calls"], 2), round(v["bytes"] / 2 ** 20, 3))
                for k, v in e["step_collectives"].items() if v["calls"]}
        gathered = e["step_collectives"]["all-gather"]["largest"]
        peaks = [f"{r[label]:.2f}" for r in res["peak_gib_by_rank"]]
        print(f"sharded {arch} engine: {e['requests']} requests, "
              f"{e['tokens']} tokens; warm {e['warm_tokens']} tokens in "
              f"{e['warm_s']:.3f} s ({e['warm_tok_per_s']:.1f} tok/s), "
              f"{e['warm_steps']} steps, {1e3 * e['step_s']:.1f} ms a traced "
              f"decode step, {e.get('host_launches_per_step', 0):.0f} host "
              f"launches a step (rank 0), device busy "
              f"{100 * e.get('busy_share', 0):.1f}% (rank 0); collectives a "
              f"decode step (calls, MiB) {coll}, largest all-gather "
              f"{gathered} bytes (smallest mixer weight "
              f"{e.get('mixer_weight_bytes', 0)}); peak GiB by rank {peaks} "
              f"on {card}", flush=True)
        if e["requests"] != n or e["tokens"] != n * SHARD_SERVE["max_new"] \
                or not e["in_vocab"]:
            fail(f"the sharded {arch} engine did not finish every request in "
                 f"the vocabulary")
        launched = res["paths"][label]["launches"]
        if min(launched[k] for k in want_kernels[arch]) < 1:
            fail(f"the sharded {arch} engine did not run "
                 f"{want_kernels[arch]}: {launched}")
        if e.get("mixer_weight_bytes") and \
                gathered >= e["mixer_weight_bytes"]:
            fail(f"the sharded {arch} engine gathers a mixer weight on a "
                 f"decode step")
    for arch, got in res["logits"].items():
        single, f32 = refs["logits"][arch]
        for i, what in enumerate(("prefill", "decode")):
            if got[i].shape != single[i].shape \
                    or not torch.isfinite(got[i]).all() \
                    or not shard_close(f"sharded {arch} {what}", got[i],
                                       single[i], f32[i]):
                fail(f"sharded {arch} {what} logits differ from one rank's")
    wl = res["paths"]["11 whisper-base sharded"]["launches"]
    if min(wl["flash_attention"], wl["decode_attention"]) < 1:
        fail(f"sharded whisper-base did not run flash and decode: {wl}")
    pg = res["paged"]
    print(f"sharded paged gemma-2b engine: {pg['hits']} prefix hit(s), "
          f"{pg['prefills']} prefills, resumed request "
          f"{'=' if pg['tokens'][0] == pg['dense'][0] else '!='} the "
          f"uninterrupted sharded engine's tokens; launches "
          f"{res['paths']['11 gemma-2b sharded paged engine']['launches']}",
          flush=True)
    if pg["hits"] != 1 or pg["prefills"] != 3 or not pg["returned"] \
            or pg["tokens"][0] != pg["dense"][0]:
        fail(f"the sharded paged engine: {pg}")
    pool = res["pool"]
    print(f"paged kernel on rank 0's qwen2-vl-2b pools (bf16): {pool}",
          flush=True)
    qcfg, m = _cfg("qwen2-vl-2b"), SHARD_MESH[1]
    if res["paths"]["11 qwen2-vl-2b paged pool"]["launches"][
            "paged_attention"] != pool["layers"] \
            or pool["heads"] != (qcfg.n_heads // m, qcfg.n_kv_heads // m):
        fail("the paged kernel did not run once per layer on a rank's pool")
    gaps = refs["moe_bf16_gap"]
    print("deepseek-moe-16b one rank, bf16 vs float32 (prefill, decode) of "
          "the float32 rms: " + ", ".join(
              f"seed {k} {100 * a:.2f}% / {100 * b:.2f}%"
              for k, (a, b) in gaps.items()), flush=True)
    for label in ("ep_a2a", "expert_parallel"):
        for i, what in enumerate(("prefill", "decode")):
            got = res["moe"][label][i]
            if got.shape != refs["moe"][i].shape \
                    or not torch.isfinite(got).all():
                fail(f"deepseek {label} {what}: logits {tuple(got.shape)} "
                     f"not finite or not of one rank's shape")
            print(f"sharded deepseek-moe-16b {label} {what}, bf16 (printed, "
                  f"not held: routing flips on near ties): "
                  f"{100 * _rel(got, refs['moe'][i]):.2f}% from one rank's "
                  f"dense dispatch, {100 * _rel(got, refs['moe_f32'][i]):.2f}"
                  f"% from the float32 model (one rank's "
                  f"{100 * gaps[0][i]:.2f}%)", flush=True)
    held = [(f"expert_parallel {w}, through the model", g, r) for w, g, r in
            zip(("prefill", "decode"), res["moe"]["expert_parallel_f32"],
                refs["moe_f32"], strict=True)]
    held.append((f"ep_a2a layer {MOE_CHECK_LAYER} alone at capacity "
                 f"{MOE_CAPACITY:g}", res["moe"]["ep_a2a_layer_f32"],
                 refs["moe_layer_f32"]))
    for what, got, want in held:
        rel = _rel(got, want)
        print(f"sharded deepseek-moe-16b {what}, float32, vs one rank's "
              f"float32 dense dispatch: {100 * rel:.4f}% of its rms (gate "
              f"{100 * SHARD_F32_GATE:.2f}%)", flush=True)
        if got.shape != want.shape or not rel <= SHARD_F32_GATE:
            fail(f"deepseek {what}: float32 output differs")
    a2a = res["paths"]["11 deepseek-moe-16b ep_a2a"]["collectives"][
        "all-to-all"]
    moe_layers = res["moe_layers"]
    print(f"ep_a2a all-to-all: {a2a['calls']} calls, "
          f"{a2a['bytes'] / moe_layers / 2 / 2 ** 20:.1f} MiB a layer a "
          f"forward on rank 0 (5 a layer: 3 re-lay the experts, 2 move the "
          f"rows)", flush=True)
    if a2a["calls"] != 5 * moe_layers * 2:
        fail("ep_a2a did not run its all-to-alls")
    t, want, fault = res["train"], refs["train"], refs["train_fault"]
    got = _train_readings(t, want, t["last_params"], t["last_moments"])
    print(f"sharded train step (gemma-2b, {SHARD_TRAIN_LAYERS} layers, full "
          f"width): loss {t['loss']:.5f}, grad_norm {t['grad_norm']:.5f}, "
          f"update_norm {t['update_norm']:.6f}; one rank {want['loss']:.5f}, "
          f"{want['grad_norm']:.5f}, {want['update_norm']:.6f}; moments "
          f"{res['moment_bytes'] / 2 ** 30:.2f} GiB a rank", flush=True)
    for k, gate in SHARD_TRAIN_GATES.items():
        print(f"  {k}: sharded {got[k]:.3e}, gate {gate:g}, the fault (one "
              f"rank on half the batch) {fault[k]:.3e}", flush=True)
        if not got[k] <= gate:
            fail(f"the sharded train step's {k} is off the single rank's")
    if all(fault[k] <= gate for k, gate in SHARD_TRAIN_GATES.items()):
        fail("the train step's gates pass a step on half the batch")
    head_gathers(res)
    seq_parallel_readings(res)
    for arch in SHARD_SMALL:
        same = res["small"][arch] == refs["small"][arch]
        print(f"reduced f32 {arch} engine, {world} ranks on the card vs one "
              f"CPU process: {'same' if same else 'DIFFERENT'} greedy tokens",
              flush=True)
        if not same:
            fail(f"sharded reduced {arch}: {res['small'][arch]} vs "
                 f"{refs['small'][arch]}")


# ---------------------------------------------------------------------------
# phase 12: the deployment models at full width, then the examples
# ---------------------------------------------------------------------------


def run_deployments(run_path, paths, card: str) -> list:
    """Phase 12's engines (DEPLOY_ENGINES), each built, checked and freed
    before the next; on the paged gemma3-12b engine, an eviction and resume
    against the dense engine and the paged kernel on its global layers'
    pools. Returns each engine's readings."""
    import torch

    def run_path_out(name, fn):
        out = run_path(name, fn)
        return paths[name], out

    # the profiler's first use in a process pays its start-up: spend
    # it here, not in the first engine's traced steps
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        torch.ones(1, device=DEVICE).add_(1)
        torch.cuda.synchronize()
    out = []
    for arch, flags in DEPLOY_ENGINES:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        eng, readings = big_engine(arch, flags, None, run_path_out, False,
                                   card, trace_steps=DEPLOY_TRACED_STEPS)
        cfg, label = eng.cfg, " ".join([arch] + flags)
        if cfg.sliding_window:
            lengths = [len(r.prompt) for r in eng.completed[:8]]
            w = cfg.sliding_window
            if min(lengths) > w or max(lengths) <= w:
                fail(f"{label}: prompts {lengths} do not fall on both sides "
                     f"of the {w}-slot window")
        if eng.paged:
            readings.update(paged_deployment(eng, run_path, paths, out))
        out.append(readings)
        del eng
    torch.cuda.empty_cache()
    return out


def paged_deployment(eng, run_path, paths, earlier) -> dict:
    """The paged gemma3-12b engine of phase 12: admission stalled, every
    block returned, no prefix index (its rolling windows are snapshot),
    the launcher's tokens beside the dense engine's (printed); then
    `paged_pool_check` at the engine's 2048 slots with a
    DEPLOY_POOL_PROMPT-token prompt,
    whose resume crosses slot 1024, and the paged kernel on the 8 global
    layers' pools against the decode kernel on the dense slot."""
    cfg, arch = eng.cfg, eng.cfg.arch_id
    if eng.n_kv_stalls < 1:
        fail(f"paged {arch}: the pool never stalled admission")
    if eng.kv.free_blocks != eng.kv.n_blocks:
        fail(f"paged {arch}: the engine did not return every block")
    if eng.kv.supports_prefix:
        fail(f"paged {arch}: a model with rolling windows keeps a prefix "
             f"index")
    dense = next((r for r in earlier if r["arch"] == arch
                  and "--paged" not in r["flags"]), None)
    same = dense is not None and dense["generated"] == \
        sorted_tokens(eng.completed[:8])
    label = f"paged pool {arch}"
    rows, outs = run_path(label, lambda: paged_pool_check(
        eng.params, cfg, max_seq=eng.max_seq, prompt_len=DEPLOY_POOL_PROMPT))
    n_attn = cfg.attention_layer_count()
    n_global = n_attn // sum(cfg.local_global_pattern)
    if rows["layers"] != n_global or paths[label]["paged_attention"] \
            != n_global or rows["snapshot_layers"] != n_attn - n_global \
            or rows["snapshot_leaves"] != 2 * (n_attn - n_global):
        fail(f"{label}: the paged kernel ran on {rows['layers']} pools "
             f"({paths[label]['paged_attention']} launches), "
             f"{rows['snapshot_layers']} layers snapshot; expected "
             f"{n_global} global layers paged")
    if not rows["valid_len"] < cfg.sliding_window < DEPLOY_POOL_PROMPT + 24:
        fail(f"{label}: the resumed request does not cross the window")
    decode_yardstick(rows, outs)
    del outs
    print(f"paged {arch}: {eng.n_kv_stalls} admission stalls, "
          f"{eng.kv.n_blocks} blocks; launcher tokens "
          f"{'=' if same else '!='} the dense engine's; evicted at position "
          f"{rows['valid_len']} and resumed past slot {cfg.sliding_window} "
          f"with the dense engine's tokens; paged kernel on the live pools "
          f"{rows}", flush=True)
    return dict(kv_stalls=eng.n_kv_stalls, kv_blocks=eng.kv.n_blocks,
                launcher_tokens_as_dense=same, pool=rows)


def sorted_tokens(done) -> list:
    return [r.generated for r in sorted(done, key=lambda r: r.rid)]


def zoo_launches(cfg) -> dict:
    """The kernels one arch_zoo tour launches: one prefill of the batch,
    one decode step. Flash once an attention layer a prefill (whisper: its
    encoder, self and cross layers, and its cross layers again at decode),
    decode once an attention layer a step (MLA decodes by matrix products),
    ssd_diag once a Mamba-2 layer a prefill."""
    from repro_torch.models.transformer import block_program
    n_attn = cfg.attention_layer_count()
    n_ssm = sum(spec.kind == "ssm" for spec in block_program(cfg).layers())
    flash = n_attn
    if cfg.enc_dec:
        flash = cfg.n_encoder_layers + 3 * cfg.n_layers
    return {"flash_attention": flash,
            "decode_attention": 0 if cfg.mla is not None else n_attn,
            "paged_attention": 0, "ssd_diag": n_ssm}


def run_examples(run_path, paths, card: str) -> dict:
    """Phase 12's examples on the card: arch_zoo's tour of all 10 archs,
    quickstart's train / serve / schedule, and train_100m for
    TRAIN_100M_STEPS steps with its checkpoint read back."""
    import tempfile
    import torch
    from repro_torch.configs import ASSIGNED_ARCHS, get_config
    from repro_torch.examples import arch_zoo, quickstart, train_100m
    from repro_torch.training import load_checkpoint
    from repro_torch.training.optimizer import leaves

    for arch in ASSIGNED_ARCHS:
        label = f"arch_zoo {arch}"
        res = run_path(label, lambda arch=arch: arch_zoo.main(
            ["--arch", arch]))[arch]
        cfg = get_config(arch).reduced()
        got = {k: v for k, v in paths[label].items() if k in (
            "flash_attention", "decode_attention", "paged_attention",
            "ssd_diag")}
        if got != zoo_launches(cfg):
            fail(f"{label}: launches {got}, expected {zoo_launches(cfg)}")
        if res["logits"].shape != (2, cfg.vocab_size) \
                or not bool(torch.isfinite(res["logits"]).all()):
            fail(f"{label}: decode logits not finite or of the wrong shape")
    print(f"arch_zoo: {len(ASSIGNED_ARCHS)} archs toured on {card}; "
          f"launches {[paths[f'arch_zoo {a}'] for a in ASSIGNED_ARCHS]}",
          flush=True)

    torch.cuda.reset_peak_memory_stats()
    q = run_path("quickstart", lambda: quickstart.main([]))
    q_losses = [h["loss"] for h in q["history"]]
    n_layers = q["engine"].cfg.n_layers
    ql = paths["quickstart"]
    if not all(map(math.isfinite, q_losses)) or q_losses[-1] >= q_losses[0]:
        fail(f"quickstart: losses {q_losses}")
    if [len(r.generated) for r in q["requests"]] != [8] * 6 \
            or len(q["schedule"]) != 2:
        fail("quickstart: not every request served or schedule row printed")
    if ql["flash_attention"] != (30 + 6) * n_layers \
            or ql["decode_attention"] != q["engine"].n_decode_steps * n_layers:
        fail(f"quickstart: launches {ql}, expected flash (30 steps + 6 "
             f"prefills) x {n_layers}")
    print(f"quickstart on {card}: loss {q_losses[0]:.3f} -> "
          f"{q_losses[-1]:.3f}, "
          f"6 requests served, schedule {q['schedule']}; launches {ql}",
          flush=True)

    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as ckpt:
        t = run_path("train_100m", lambda: train_100m.main(
            ["--steps", str(TRAIN_100M_STEPS), "--ckpt", ckpt]))
        cfg, hist = t["cfg"], t["history"]
        back, extra = load_checkpoint(ckpt, t["params"], cfg,
                                      device=DEVICE)
    losses = [h["loss"] for h in hist]
    if not all(map(math.isfinite, losses)) or losses[-1] >= losses[0]:
        fail(f"train_100m: losses {losses}")
    if extra != {"steps": TRAIN_100M_STEPS, "arch": cfg.arch_id} or not all(
            torch.equal(a, b) for a, b in zip(
                leaves(back), leaves(t["params"]), strict=True)):
        fail("train_100m: the checkpoint does not read back to the weights")
    tl = paths["train_100m"]
    if tl["flash_attention"] != TRAIN_100M_STEPS * cfg.n_layers:
        fail(f"train_100m: flash {tl['flash_attention']}, expected "
             f"{TRAIN_100M_STEPS} x {cfg.n_layers}")
    batch, seq = t["batch"], t["seq"]
    step_s = (hist[-1]["elapsed_s"] - hist[0]["elapsed_s"]) \
        / (hist[-1]["step"] - hist[0]["step"])
    print(f"train_100m on {card}: {cfg.param_count() / 1e6:.0f}M params, "
          f"{TRAIN_100M_STEPS} steps of {batch} x {seq} tokens, loss "
          f"{losses[0]:.3f} -> {losses[-1]:.3f}; {1e3 * step_s:.1f} ms a "
          f"step after step 0, {batch * seq / step_s:.0f} tokens/s, "
          f"{t['seconds']:.1f} s in all; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB; "
          f"checkpoint read back bit for bit; flash {tl['flash_attention']}",
          flush=True)
    return dict(train_100m_loss=(losses[0], losses[-1]),
                train_100m_tok_per_s=batch * seq / step_s,
                quickstart_loss=(q_losses[0], q_losses[-1]))


def step_launches(src: str, archs) -> None:
    """Host kernel launches a step of warm single-device engines (see the
    module's docstring)."""
    sys.path.insert(0, str(Path(src).resolve()))
    import numpy as np
    import torch
    from repro_torch.kernels import _build
    from repro_torch.models import init_params
    from repro_torch.serving.engine import ServingEngine
    _build.build()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    for arch in archs:
        cfg = _cfg(arch, **({"n_layers": 4} if arch == "mixtral-8x7b"
                            else {}))
        eng = ServingEngine(cfg, init_params(cfg, seed=0, device="cuda"),
                            max_batch=4, max_seq=256, device="cuda")
        rng = np.random.default_rng(0)
        prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size,
                                                 int(rng.integers(4, 24)))]
                   for _ in range(8)]
        runs = {}
        for run in ("cold", "warm"):
            for p in prompts:
                eng.submit(p, max_new_tokens=16)
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            steps = 0
            with torch.profiler.profile(activities=acts) as prof:
                while eng.queue or eng.active_slots:
                    eng.step()
                    steps += 1
                torch.cuda.synchronize()
            launches = sum(e.count for e in prof.key_averages() if e.key in (
                "cudaLaunchKernel", "cuLaunchKernelEx"))
            runs[run] = dict(steps=steps, launches=launches,
                             per_step=launches / steps)
        print(json.dumps({"arch": arch, "card": card, **runs}), flush=True)
        del eng
        torch.cuda.empty_cache()


def deploy_tokens(src: str, archs) -> None:
    """Phase 12's engines from SRC's `repro_torch`: peak GiB and a digest
    of the greedy tokens an engine (see the module's docstring)."""
    import hashlib
    sys.path.insert(0, str(Path(src).resolve()))
    import torch
    from repro_torch.kernels import _build, ops
    _build.build()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()

    def run_path(name, fn):
        ops.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        return ops.kernel_launches(), out

    for arch, flags in DEPLOY_ENGINES:
        if archs and arch not in archs:
            continue
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        eng, r = big_engine(arch, flags, None, run_path, False, card)
        digest = hashlib.sha1(json.dumps(r["generated"]).encode())
        print(json.dumps({"arch": arch, "flags": flags, "card": card,
                          "peak_gib": torch.cuda.max_memory_allocated()
                          / 2 ** 30, "tokens_sha1": digest.hexdigest(),
                          "warm_tok_per_s": r["warm_tok_per_s"]}),
              flush=True)
        del eng
    torch.cuda.empty_cache()


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--deploy-tokens"]:
        if len(argv) < 2:
            fail("usage: chip_smoke.py --deploy-tokens SRC [ARCH...]")
        deploy_tokens(argv[1], argv[2:])
        return
    if argv[:1] == ["--step-launches"]:
        if len(argv) < 3:
            fail("usage: chip_smoke.py --step-launches SRC ARCH...")
        step_launches(argv[1], argv[2:])
        return
    profile = "--profile" in argv
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
    dev = torch.device(DEVICE)
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
    tensor_core_selftest(dev)
    rows = [check(case, dev)
            for check, cases in ((check_flash, FLASH_CASES),
                                 (check_decode, DECODE_CASES),
                                 (check_paged, PAGED_CASES),
                                 (check_ssd, SSD_CASES))
            for case in cases]
    rows += [check_flash(case, dev, causal=False)
             for case in NONCAUSAL_FLASH_CASES]
    rows += [check_flash(case, dev, causal=causal, lse=True)
             for case, causal in LSE_CASES]
    rows += [check_flash_grad(case, dev) for case in GRAD_CASES]
    rows += [check_decode_lse(case, dev) for case in DECODE_LSE_CASES]
    rows += [check_cp(case, dev) for case in CP_CASES]
    fns = [r.pop("fn") for r in rows]
    yard = [(r, r.pop("dense_fn")) for r in rows if "dense_fn" in r]
    times = device_us(fns + [fn for _, fn in yard])
    for r, us in zip(rows, times[:len(rows)], strict=True):
        r["device_us"] = us
    for (r, _), us in zip(yard, times[len(rows):], strict=True):
        r["dense_decode_us"] = us
    # the timed closures hold every case's inputs: free them, so that the
    # engines' peak memory below is their own
    del fns, yard
    torch.cuda.empty_cache()
    for r in rows:
        lib_ms = ("none" if r["library_ms"] is None
                  else f"{r['library_ms']:.4f}")
        extra = (f" cpu_err={r['cpu_err']:.3e} ({r['cpu_err_rms']:.2e} "
                 f"rms) out_rms={r['out_rms']:.3e}"
                 if "cpu_err" in r else "")
        if "checked_ms" in r:
            extra += f" checked_ms={r['checked_ms']:.4f}"
        if "dense_decode_us" in r:
            extra += f" dense_decode_us={r['dense_decode_us']:.2f}"
        if "lse_err" in r:
            extra += f" lse_err={r['lse_err']:.3e}"
        if "bwd_ms" in r:
            extra += f" bwd_ms={r['bwd_ms']:.4f}"
        if "whole_err" in r:
            extra += f" whole_err={r['whole_err']:.3e}"
        print(f"{r['kernel']:16s} {r['dtype']:8s} {r['label']:38s} "
              f"err={r['max_abs_err']:.3e} ({100 * r['err_rms']:.2f}% "
              f"rms){extra} ms={r['ms']:.4f} "
              f"device_us={r['device_us']:.2f} "
              f"plain_ms={r['plain_ms']:.4f} "
              f"library_ms={lib_ms} bound_ms={r['bound_ms']:.5f} "
              f"({r['bound_by']}) {'ok' if r['ok'] else 'MISMATCH'}",
              flush=True)
    bad = [r for r in rows if not r["ok"]]
    if bad:
        fail(f"{len(bad)} kernel check(s) disagree with the plain version: "
             + "; ".join(f"{r['kernel']} {r['label']} {r['dtype']} "
                         f"err={r['max_abs_err']:.3e}" for r in bad))

    # the main paths: every count is set to 0 just before a path runs and
    # read just after it
    paths = {}

    def run_path(name, fn):
        ops.reset_launches()
        out = fn()
        paths[name] = ops.kernel_launches()
        return out

    # 4. full-width gemma-2b engine through the launcher
    eng, done, secs = run_path("gemma-2b", lambda: serve.main(SERVE_ARGS))
    engine_launches = paths["gemma-2b"]
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
        on_card = run_path(f"reduced {arch}",
                           lambda arch=arch: small_engine_tokens(arch, DEVICE))
        launches = paths[f"reduced {arch}"]
        on_cpu = small_engine_tokens(arch, "cpu")
        print(f"reduced f32 {arch} engine, card vs CPU plain path: "
              f"{'same' if on_card == on_cpu else 'DIFFERENT'} greedy "
              f"tokens; launches on the card {launches}", flush=True)
        if on_card != on_cpu:
            fail(f"{arch}: greedy tokens differ: card {on_card} "
                 f"cpu {on_cpu}")
        want = ("ssd_diag",) if arch.startswith("mamba2") \
            else ("flash_attention",) if arch.startswith("minicpm3") \
            else ("flash_attention", "decode_attention")
        if min(launches[k] for k in want) <= 0:
            fail(f"{arch}: the reduced engine did not run {want}")
        if arch.startswith("minicpm3") and launches["decode_attention"]:
            fail(f"{arch}: MLA decode ran the decode kernel")

    # 5. full-width mamba2-2.7b through the launcher, then a reduced paged
    # mamba2 engine evicting and resuming a request
    eng, done, secs = run_path("mamba2-2.7b", lambda: serve.main(MAMBA_ARGS))
    mamba = paths["mamba2-2.7b"]
    toks = sum(len(r.generated) for r in done)
    lengths = sorted(len(r.prompt) for r in done)
    print(f"mamba2 engine: {len(done)} requests (prompts {lengths}), {toks} "
          f"tokens, {secs:.2f} s, {toks / secs:.1f} tok/s on {name}; "
          f"launches {mamba}, prefills {eng.n_prefills}, layers "
          f"{eng.cfg.n_layers}", flush=True)
    if len(done) != 6 or any(len(r.generated) != 8 for r in done):
        fail("the mamba2 engine did not finish every request")
    if any(not 0 <= t < eng.cfg.vocab_size for r in done
           for t in r.generated):
        fail("the mamba2 engine produced tokens outside the vocabulary")
    if mamba["ssd_diag"] != eng.n_prefills * eng.cfg.n_layers:
        fail("mamba2 prefill did not run the SSD kernel once per layer")
    if not any(n > 128 for n in lengths):
        fail("no mamba2 prompt reached the 256 bucket (chunk 256)")
    warm = warm_engine_run(eng, [r.prompt for r in done], profile, new=8)
    print(f"mamba2 engine, warm: {warm['tokens']} tokens in "
          f"{warm['seconds']:.3f} s ({warm['tok_per_s']:.1f} tok/s), "
          f"{warm['steps']} steps, {warm['ms_per_step']:.2f} ms/step on "
          f"{name}", flush=True)
    del eng, done
    torch.cuda.empty_cache()

    for arch in ("mamba2-2.7b", "gemma-2b", "minicpm3-4b",
                 "recurrentgemma-2b"):
        label = f"reduced paged {arch}"
        card, card_ref, hits, prefills = run_path(
            label, lambda arch=arch: small_paged_run(arch, DEVICE))
        cpu, cpu_ref, cpu_hits, _ = small_paged_run(arch, "cpu")
        print(f"reduced f32 paged {arch} engine, evict + resubmit: card "
              f"{'=' if card == cpu else '!='} CPU; resumed request "
              f"{'=' if card[0] == card_ref[0] else '!='} uninterrupted; "
              f"prefix hits {hits}, prefills {prefills}; launches "
              f"{paths[label]}", flush=True)
        if card != cpu:
            fail(f"{label}: greedy tokens differ: card {card} cpu {cpu}")
        if card[0] != card_ref[0] or cpu != cpu_ref:
            fail(f"{label}: the resumed request's tokens differ from the "
                 f"uninterrupted run's")
        recurrent = arch.startswith(("mamba2", "recurrentgemma"))
        if prefills != 3 or hits != cpu_hits or hits != (0 if recurrent
                                                         else 1):
            fail(f"{label}: {prefills} prefills and {hits} prefix hits")

    # 6. full-width paged gemma-2b: stalls through the launcher; eviction,
    # the paged kernel on the pool, and a prefix hit on engines of the
    # same weights
    peng, pdone, psecs = run_path("paged gemma-2b",
                                  lambda: serve.main(PAGED_ARGS))
    paged_launches = paths["paged gemma-2b"]
    print(f"paged engine: {len(pdone)} requests in {psecs:.2f} s on {name}; "
          f"{peng.kv.n_blocks} blocks, {peng.n_kv_stalls} admission stalls, "
          f"launches {paged_launches}", flush=True)
    if len(pdone) != 8 or any(len(r.generated) != 16 for r in pdone):
        fail("the paged engine did not finish every request")
    if peng.n_kv_stalls < 1:
        fail("the paged engine's pool never stalled admission")
    if paged_launches["flash_attention"] != peng.n_prefills * n_layers \
            or paged_launches["decode_attention"] <= 0:
        fail("the paged engine did not run the flash and decode kernels")
    if peng.kv.free_blocks != peng.kv.n_blocks:
        fail("the paged engine did not return every block")
    pool_rows, pool_outs = run_path(
        "paged pool", lambda: paged_pool_check(peng.params, peng.cfg))
    if paths["paged pool"]["paged_attention"] != pool_rows["layers"] \
            or pool_rows["layers"] != n_layers:
        fail("the paged kernel did not run once per layer on the pool")
    decode_yardstick(pool_rows, pool_outs)
    del pool_outs
    print(f"paged kernel on the live pool (gemma-2b, bf16): {pool_rows}",
          flush=True)
    heng = run_path("paged prefix", lambda: full_prefix_hit(peng.params,
                                                            peng.cfg))
    print(f"paged prefix: {heng.n_prefix_hits} hit(s), "
          f"{heng.prefix_tokens_reused} prompt tokens reused, "
          f"{heng.n_prefills} prefills; launches {paths['paged prefix']}",
          flush=True)
    if heng.n_prefix_hits < 1 or heng.prefix_tokens_reused < 32:
        fail("the full-width paged engine took no prefix hit")
    if any(not 0 <= t < vocab for r in heng.completed for t in r.generated):
        fail("the prefix-hit engine produced tokens outside the vocabulary")
    del peng, pdone, heng
    torch.cuda.empty_cache()

    # 7. the PerLLM fleet, dense and paged
    srv = run_path("fleet", lambda: serve.main(FLEET_ARGS))
    fleet_launches = paths["fleet"]
    served = srv.stats["n_served"]
    print(f"fleet: served {served}, per_server "
          f"{srv.stats['per_server_served']}, launches {fleet_launches}",
          flush=True)
    if served != 12:
        fail(f"the fleet served {served} of 12 requests")
    if min(fleet_launches["flash_attention"],
           fleet_launches["decode_attention"]) <= 0:
        fail("the fleet did not run both kernels")
    paged_fleet = FLEET_ARGS + ["--paged"]
    srv = run_path("paged fleet", lambda: serve.main(paged_fleet))
    cpu_srv = serve.main([a if a != DEVICE else "cpu" for a in paged_fleet])
    per_server = srv.stats["per_server_served"]
    print(f"paged fleet: served {srv.stats['n_served']}, per_server "
          f"{per_server} (CPU {cpu_srv.stats['per_server_served']}), "
          f"launches {paths['paged fleet']}", flush=True)
    if srv.stats["n_served"] != 12 \
            or per_server != cpu_srv.stats["per_server_served"]:
        fail("the paged fleet did not serve 12 of 12 as the CPU fleet does")
    # the serving example (the JAX package's examples/perllm_serving.py)
    from repro_torch.examples import perllm_serving
    ex = run_path("serving example", lambda: perllm_serving.main([]))
    print(f"serving example: executed {ex['done']}/{ex['requests']} on the "
          f"card's engines (edge0, edge1, cloud) {ex['per_engine']}; "
          f"launches {paths['serving example']}", flush=True)
    if ex["done"] != ex["requests"] or min(
            paths["serving example"][k]
            for k in ("flash_attention", "decode_attention")) < 1:
        fail("the serving example did not run every request on the card")
    del ex

    # 8. MoE and MLA at full width, each freed before the next
    def run_path_out(name, fn):
        out = run_path(name, fn)
        return paths[name], out

    for arch, flags, n_layers in BIG_ENGINES:
        torch.cuda.reset_peak_memory_stats()
        # the paged minicpm3 run is not traced: its trace repeats the dense
        # one's, and a 62-layer trace takes minutes to read
        eng, _ = big_engine(arch, flags, n_layers, run_path_out,
                            profile and not flags, name)
        if eng.paged:
            heng = run_path(f"paged prefix {arch}",
                            lambda: full_prefix_hit(eng.params, eng.cfg))
            print(f"paged prefix {arch}: {heng.n_prefix_hits} hit(s) on the "
                  f"latent pages, {heng.prefix_tokens_reused} prompt tokens "
                  f"reused, {heng.n_prefills} prefills; launches "
                  f"{paths[f'paged prefix {arch}']}", flush=True)
            if heng.n_prefix_hits < 1 or heng.prefix_tokens_reused < 32:
                fail(f"the full-width paged {arch} engine took no prefix hit")
            del heng
        del eng
        torch.cuda.empty_cache()

    # 9. the RG-LRU hybrid and M-RoPE at full width, each freed before the
    # next; on the paged recurrentgemma engine's pools, the paged kernel at
    # 10 q-heads a kv-head
    for arch, flags, n_layers in NEW_ENGINES:
        torch.cuda.reset_peak_memory_stats()
        eng, _ = big_engine(arch, flags, n_layers, run_path_out,
                            profile and not flags, name)
        if eng.paged:
            if eng.kv.supports_prefix:
                fail(f"the paged {arch} engine keeps a prefix index")
            label = f"paged pool {arch}"
            rows_p, outs_p = run_path(
                label, lambda: paged_pool_check(eng.params, eng.cfg))
            if paths[label]["paged_attention"] != rows_p["layers"] \
                    or rows_p["layers"] != eng.cfg.attention_layer_count():
                fail(f"the paged kernel did not run once per attention layer "
                     f"on the {arch} pools")
            decode_yardstick(rows_p, outs_p)
            del outs_p
            print(f"paged kernel on the live pools ({arch}, bf16): {rows_p}",
                  flush=True)
        del eng
        torch.cuda.empty_cache()

    # 10. whisper-base at the model level, then training
    run_whisper_and_training(run_path, paths, name, dev, profile)

    # 11. the sharded paths: 4 ranks on the one card
    torch.cuda.empty_cache()
    run_sharded(paths, name, dev)

    # 12. the deployment models at full width, then the three examples
    t12 = time.time()
    deployed = run_deployments(run_path, paths, card_line)
    examples = run_examples(run_path, paths, card_line)
    print("deployments " + json.dumps({
        "card": card_line, "seconds": time.time() - t12,
        "engines": [{k: v for k, v in r.items() if k != "generated"}
                    for r in deployed], "examples": examples}), flush=True)

    # result
    path_rows = {}
    for r in rows:
        path_rows.setdefault(r["kernel"], r)
    sources = {
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:80"),
        "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                             "src/repro/kernels/decode_attention.py:64"),
        "paged_attention": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                            "src/repro/kernels/paged_attention.py:75"),
        "ssd_diag": ("src/repro_torch/kernels/csrc/ssd_diag.cu",
                     "src/repro/kernels/ssd_diag.py:46"),
        # the decode kernel writing each row's logsumexp (phase 11's CP
        # decode), counted apart
        "decode_attention_lse": (
            "src/repro_torch/kernels/csrc/decode_attention.cu",
            "src/repro/kernels/decode_attention.py:64"),
    }
    kernels = []
    for kname, r in path_rows.items():
        if kname not in sources:     # the CP body's rows: no one kernel
            continue
        by_path = {p: c[kname] for p, c in paths.items() if c[kname]}
        if not by_path:
            fail(f"{kname} was launched on no main path")
        kernels.append({
            "name": kname, "route": "cuda", "source": sources[kname][0],
            "replaces": sources[kname][1],
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "device_us": r["device_us"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "library": LIBRARY[kname], "shape": r["shape"],
            "dtype": r["dtype"],
            **({"checked_ms": r["checked_ms"]} if "checked_ms" in r
               else {})})
    print(f"total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
