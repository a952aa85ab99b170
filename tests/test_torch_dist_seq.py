"""Sequence parallelism of the residual stream on 8 gloo ranks.

Under a mesh the port splits the residual stream between the blocks over
the sequence on the ``model`` axis wherever the JAX package's
``shard_activation`` does (x 3-D, S > 1, S % m == 0, m > 1): a layer
gathers the sequence before its column-parallel products and
reduce-scatters its row-parallel partial sums. On a (2, 4) ``('data',
'model')`` mesh of processes, for reduced float32 configs of every family
(`test_torch_dist_jaxref.SEQ_CASES`: M-RoPE with vision rows that end
inside a rank's slice, Mamba-2, RG-LRU, MLA on its heads and, with 6 heads,
run whole; MoE with dense, capacity and ``ep_a2a`` dispatch, in the
expert-parallel constraint form, and with expert columns that do not
divide the model axis; whisper's decoder; and
two sequences of 18 tokens, which 4 does not divide), one train step
equals the port's one process (loss and grad_norm to 1e-5, parameters
after AdamW to 1e-4). A case of every family (`JAX_CASES`; gemma-2b's in
`test_torch_dist_train.py`) also equals the JAX package's sharded step on
8 host devices to the same bounds. AdamW's eps is 1e-6 here (1e-8 by
default): its first step moves a weight by lr * g / (|g| + eps) plus the
decay, so at 1e-8 a gradient near zero, which float32 sums in another
order give as 1e-10 or 3e-8, moves its weight by 0 or by most of lr
(3e-4), and no tolerance on the parameters tells the two; at 1e-6 a
gradient well above 1e-6 with the wrong sign, or lost, moves its weight
about lr or more away, so the parameter bound of 1e-4 holds the
gradients. ``ep_a2a`` routes each rank's own tokens with a capacity a
rank, which one process does not, so it is held to the JAX step alone.
The ranks' collectives show the layout: with SP the sequence
is gathered, (B_l, S, D), and no whole (B_l, S, D) partial is all-reduced;
at 18 tokens the reverse. The sharded engine's bucket prefill takes SP and
its greedy tokens equal one process's.
"""
import concurrent.futures
import dataclasses
import math
import zlib

import jax
import numpy as np
import pytest
import torch

from test_torch_dist_harness import jax_ref, run_ranks
from test_torch_dist_jaxref import (SEQ_ADAMW_EPS, SEQ_CASES, SEQ_ROWS,
                                    seq_config)
from _torch_parity import numpy_tree
from repro.models import init_params as jax_init_params
from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.models import parallel as PAR
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.serving.engine import ServingEngine
from repro_torch.training import (AdamWConfig, init_opt_state,
                                  init_opt_state_sharded, make_train_step)
from repro_torch.training.optimizer import leaves

MESH, M_AXIS = (2, 4), 4
VISION_ROWS, FRAMES = 6, 12
ENGINE_PROMPTS = [[5, 9, 23, 7, 100, 3], [31, 32, 33]]
# a case of every family: gemma-2b's SP step is held to the JAX step by
# test_torch_dist_train.py (S 32 on the same mesh)
JAX_CASES = ("qwen2-vl-2b", "mamba2-2.7b", "recurrentgemma-2b", "minicpm3-4b",
             "deepseek-moe-16b/dense", "deepseek-moe-16b/capacity",
             "deepseek-moe-16b/ep_a2a", "whisper-base")
OPT = AdamWConfig(warmup_steps=1, eps=SEQ_ADAMW_EPS)


def _port_config(name):
    arch, kw, _, _ = SEQ_CASES[name]
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                               **kw)


def _batch(name):
    """The case's train batch as numpy, from a seed: tokens and labels,
    M-RoPE's three distinct position streams, a VLM's vision rows and
    whisper's audio frames."""
    cfg = _port_config(name)
    s = SEQ_CASES[name][3]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    out = {k: rng.integers(0, cfg.vocab_size, (SEQ_ROWS, s), np.int32)
           for k in ("tokens", "labels")}
    if cfg.mrope:
        t = np.arange(s, dtype=np.int32)
        out["positions"] = np.broadcast_to(
            np.stack([t, t // 2, t % 3])[:, None], (3, SEQ_ROWS, s)).copy()
    if cfg.vision_tokens:
        out["vision_embeds"] = rng.standard_normal(
            (SEQ_ROWS, VISION_ROWS, cfg.d_model)).astype(np.float32)
    if cfg.enc_dec:
        out["audio_frames"] = rng.standard_normal(
            (SEQ_ROWS, FRAMES, cfg.d_model)).astype(np.float32)
    return out


def _torch_batch(np_batch):
    return {k: torch.as_tensor(v).long() if v.dtype.kind == "i"
            else torch.as_tensor(v) for k, v in np_batch.items()}


# (kind, result shape) of each counted collective, where `_log` put its
# hook (in the ranks)
CALLS = []


def _log():
    count = PAR._count

    def logged(kind, out):
        CALLS.append((kind, tuple(out.shape)))
        count(kind, out)
    PAR._count = logged


def _step(tcfg, params, batch, ctx_kw, ctx=None):
    """One train step: (metrics, parameters after it). ``ctx_kw``: the
    case's context fields (one process takes its MoE dispatch)."""
    if ctx is not None:
        ctx = dataclasses.replace(ctx, **ctx_kw)
        opt = init_opt_state_sharded(params, tcfg, ctx)
        step = make_train_step(tcfg, OPT, ctx=ctx)
    else:
        opt = init_opt_state(params)
        step = make_train_step(tcfg, OPT, moe_dispatch=ctx_kw.get(
            "moe_dispatch", "dense"))
    params, _, metrics = step(params, opt, batch)
    return {k: float(v) for k, v in metrics.items()}, params


def _serve(tcfg, params, ctx=None):
    eng = ServingEngine(tcfg, params, max_batch=2, max_seq=32, device="cpu",
                        ctx=ctx)
    reqs = [eng.submit(p, max_new_tokens=4) for p in ENGINE_PROMPTS]
    eng.run_until_idle()
    return [list(r.generated) for r in reqs]


def _ranked(ctx, weights, batches):
    _log()
    out = {"train": {}}
    for name, (_, _, ctx_kw, _) in SEQ_CASES.items():
        tcfg, jp = _port_config(name), weights[name]
        params = PAR.shard_params(params_from_jax(jp, tcfg, device="cpu"),
                                  ctx)
        CALLS.clear()
        metrics, params = _step(tcfg, params, _torch_batch(batches[name]),
                                ctx_kw, ctx)
        specs = PAR.param_specs(M.params_shapes(tcfg), ctx)
        out["train"][name] = {
            "metrics": metrics, "calls": list(CALLS),
            "params": PAR.map_trees(lambda t, sp: PAR.gather_tree(t, sp, ctx),
                                    params, specs)}
    tcfg, jp = _port_config("gemma-2b/s-18"), weights["gemma-2b/s-18"]
    CALLS.clear()
    out["engine"] = _serve(tcfg, PAR.shard_params(
        params_from_jax(jp, tcfg, device="cpu"), ctx), ctx)
    out["engine_calls"] = list(CALLS)
    return out


@pytest.fixture(scope="module")
def runs():
    """(the JAX mesh steps, the 8 ranks' run, the weights, the batches):
    the JAX process runs while the ranks do."""
    drawn = {}
    for name in SEQ_CASES:
        cfg = seq_config(name)
        if cfg not in drawn:
            drawn[cfg] = numpy_tree(jax_init_params(jax.random.key(0), cfg))
    weights = {name: drawn[seq_config(name)] for name in SEQ_CASES}
    batches = {name: _batch(name) for name in SEQ_CASES}
    flat = {f"{name}/{k}": v for name in JAX_CASES
            for k, v in batches[name].items()}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ref = pool.submit(jax_ref, "seq_train", flat, 600)
        got = run_ranks(_ranked, MESH, ("data", "model"), weights, batches)
        return ref.result(), got, weights, batches


def _residual_calls(calls, b_local, s, d):
    """The all-gathers of the whole sequence and the all-reduces of a whole
    partial (B_l, S, D) among `calls`, and the reduce-scatters to a slice,
    by element count (a collective counts its result as it moves it: an
    all-gather of the sequence as (m * B_l, S/m, D))."""
    whole = b_local * s * d

    def of(kind, n):
        return [c for c in calls if c[0] == kind and math.prod(c[1]) == n]
    return (of("all-gather", whole), of("all-reduce", whole),
            of("reduce-scatter", whole // M_AXIS))


@pytest.mark.parametrize("name", list(SEQ_CASES))
def test_sequence_parallel_train_step_matches_one_process_and_jax(runs,
                                                                  name):
    ref, got, weights, batches = runs
    tcfg = _port_config(name)
    _, _, ctx_kw, s = SEQ_CASES[name]
    mine = got["train"][name]
    if ctx_kw.get("moe_dispatch") != "ep_a2a":
        metrics, params = _step(tcfg, params_from_jax(weights[name], tcfg,
                                                      device="cpu"),
                                _torch_batch(batches[name]), ctx_kw)
        assert abs(mine["metrics"]["loss"] - metrics["loss"]) < 1e-5
        assert abs(mine["metrics"]["grad_norm"]
                   - metrics["grad_norm"]) < 1e-5
        for a, b in zip(leaves(mine["params"]), leaves(params),
                        strict=True):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
    if name in JAX_CASES:
        theirs = ref[name]
        assert abs(mine["metrics"]["loss"] - theirs["loss"]) < 1e-5
        assert abs(mine["metrics"]["grad_norm"] - theirs["grad_norm"]) < 1e-5
        ours = jax.tree.leaves(params_to_jax(mine["params"], tcfg))
        want = jax.tree.leaves(theirs["params"])
        assert len(ours) == len(want)
        for a, b in zip(ours, want, strict=True):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)

    gathers, reduces, scatters = _residual_calls(
        mine["calls"], SEQ_ROWS // MESH[0], s, tcfg.d_model)
    if s % M_AXIS == 0:
        # the residual is split: the sequence is gathered into each layer
        # and every row-parallel partial sum is reduce-scattered
        assert len(gathers) >= tcfg.n_layers and len(scatters) >= \
            tcfg.n_layers and not reduces
    else:
        assert reduces and not gathers and not scatters


def test_sequence_parallel_engine_prefill_matches_one_process(runs):
    """The bucket prefill (8 slots) splits the sequence; decode does not."""
    _, got, weights, _ = runs
    tcfg = _port_config("gemma-2b/s-18")
    single = _serve(tcfg, params_from_jax(weights["gemma-2b/s-18"], tcfg,
                                          device="cpu"))
    assert got["engine"] == single
    gathers, reduces, scatters = _residual_calls(got["engine_calls"], 1, 8,
                                                 tcfg.d_model)
    assert gathers and scatters and not reduces
    # decode steps keep the residual whole: (B, 1, D) partials all-reduced
    assert any(kind == "all-reduce" and shape[1:] == (1, tcfg.d_model)
               for kind, shape in got["engine_calls"])
