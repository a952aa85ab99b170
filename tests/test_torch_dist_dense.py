"""The port's tensor- and context-parallel dense path on 8 gloo ranks.

A (2, 4) ``('data', 'model')`` mesh of processes on the CPU
(`test_torch_dist_harness.run_ranks`) against the port's single-process run and the
JAX package's sharded run on 8 host devices (`test_torch_dist_jaxref.py`). The
weights are the JAX ``init_params(key 0)`` ones, carried over as numpy.
Reduced float32 gemma-2b has one kv-head on a model axis of 4, so its
cache splits its sequence over ``model`` and decode takes the
context-parallel path; reduced gemma3 adds 64-slot rolling windows.
"""
import jax
import numpy as np
import torch

from test_torch_dist_harness import jax_ref, run_ranks
from _torch_parity import config_pair, numpy_tree
from repro.models import init_params as jax_init_params
from repro_torch.models import model as M
from repro_torch.models import parallel as PAR
from repro_torch.models.convert import params_from_jax

# prompt tokens and cache slots: gemma3's local layers keep 64 of 192
CP_CASES = {"gemma-2b": (16, 32), "gemma3-12b": (128, 192)}


def _inputs():
    rng = np.random.default_rng(0)
    return {arch: rng.integers(0, 1024, (4, s + 3))
            for arch, (s, _) in CP_CASES.items()}


def _weights(arch):
    jcfg, tcfg = config_pair(arch)
    return tcfg, numpy_tree(jax_init_params(jax.random.key(0), jcfg))


def _run(tcfg, params, toks, max_seq, ctx=None):
    """Prefill, then three scalar-`pos` decode steps: the logits of each."""
    toks = torch.as_tensor(toks)
    b, total = toks.shape
    s = total - 3
    cache = M.init_cache(tcfg, b, max_seq, device="cpu", ctx=ctx)
    last, cache = M.prefill(params, {"tokens": toks[:, :s]}, cache,
                            cfg=tcfg, ctx=ctx)
    out = [last]
    for i in range(3):
        lg, cache = M.decode_step(params, toks[:, s + i:s + i + 1], cache,
                                  s + i, cfg=tcfg, ctx=ctx)
        out.append(lg)
    return torch.stack(out).numpy(), getattr(cache, "specs", None)


def _ranked_cp(ctx, weights, inputs):
    out = {}
    for arch, (_, max_seq) in CP_CASES.items():
        tcfg, jp = weights[arch]
        params = PAR.shard_params(params_from_jax(jp, tcfg, device="cpu"),
                                  ctx)
        logits, specs = _run(tcfg, params, inputs[arch], max_seq, ctx)
        out[arch] = (logits, [s["k"] for s in specs])
    out["counts"] = PAR.collective_counts()
    return out


def test_cp_decode_matches_single_process_and_jax():
    inputs = _inputs()
    weights = {arch: _weights(arch) for arch in CP_CASES}
    ref = jax_ref("cp_decode", inputs)
    got = run_ranks(_ranked_cp, (2, 4), ("data", "model"), weights, inputs)
    for arch, (_, max_seq) in CP_CASES.items():
        tcfg, jp = weights[arch]
        single, _ = _run(tcfg, params_from_jax(jp, tcfg, device="cpu"),
                         inputs[arch], max_seq)
        logits, kspecs = got[arch]
        # every cache's sequence is split over `model`: the CP decode ran
        assert all(sp == ("data", "model", None, None) for sp in kspecs)
        np.testing.assert_allclose(logits, single, rtol=0, atol=1e-5)
        np.testing.assert_allclose(logits, ref[arch], rtol=0, atol=1e-4)
    # the combine's max and sum, and the row-parallel sums
    assert got["counts"]["all-reduce"]["calls"] > 0
    assert got["counts"]["all-gather"]["calls"] > 0


def test_sharded_init_params_holds_the_single_device_draw():
    """`init_params(..., ctx=)` keeps, on every rank, the shards of the
    same draw as one device."""
    _, tcfg = config_pair("gemma-2b")
    full = M.init_params(tcfg, seed=3, device="cpu")
    for rank in (0, 5):
        ctx = PAR.ParallelContext(mesh=PAR.Mesh((2, 4), ("data", "model"),
                                                rank=rank))
        local = M.init_params(tcfg, seed=3, device="cpu", ctx=ctx)
        want = PAR.shard_params(full, ctx)
        PAR.map_trees(torch.testing.assert_close, local, want)
