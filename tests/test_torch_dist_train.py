"""The port's sharded train step on 8 gloo ranks.

Reduced float32 gemma-2b (``n_layers=2, d_model=128, vocab_size=512``) on a
(2, 4) ``('data', 'model')`` mesh of processes, with the JAX test's batch
(``dummy_batch(key 1)``, handed over as numpy): the loss of one step equals
the JAX package's sharded step (8 host devices, `test_torch_dist_jaxref.py`) and
the port's single-process step; the parameters after it agree within 5e-3
of the JAX step's and within 1e-4 of the port's single-process step's; two
microbatches give the step of one; and the AdamW moments are cut as ZeRO-1
says (`parallel.opt_state_shardings`).
"""
import jax
import numpy as np
import torch

from test_torch_dist_harness import jax_ref, run_ranks
from _torch_parity import config_pair, numpy_tree
from repro.models import init_params as jax_init_params
from repro_torch.models import model as M
from repro_torch.models import parallel as PAR
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.training import (AdamWConfig, init_opt_state,
                                  init_opt_state_sharded, make_train_step)
from repro_torch.training.optimizer import leaves

REDUCED = dict(n_layers=2, d_model=128, vocab_size=512)


def _batch(np_batch):
    return {k: torch.as_tensor(np.asarray(v)).long()
            for k, v in np_batch.items()}


def _ranked(ctx, tcfg, jp, np_batch, microbatches):
    out = {}
    for mb in microbatches:
        params = PAR.shard_params(params_from_jax(jp, tcfg, device="cpu"),
                                  ctx)
        opt = init_opt_state_sharded(params, tcfg, ctx)
        step = make_train_step(tcfg, AdamWConfig(warmup_steps=1),
                               microbatches=mb, ctx=ctx)
        params, opt, metrics = step(params, opt, _batch(np_batch))
        specs = PAR.param_specs(M.params_shapes(tcfg), ctx)

        def whole(t, spec):
            for d, e in enumerate(spec):
                if e is not None:
                    t = PAR.all_gather(t, ctx, e, d)
            return t
        out[mb] = {
            "metrics": {k: float(v) for k, v in metrics.items()},
            "params": PAR.map_trees(whole, params, specs),
            "moments": PAR.map_trees(lambda t: tuple(t.shape), opt.m),
            "counts": PAR.collective_counts(),
        }
        PAR.reset_collectives()
    return out


def test_sharded_train_step_matches_jax_and_single_process():
    jcfg, tcfg = config_pair("gemma-2b", **REDUCED)
    jp = numpy_tree(jax_init_params(jax.random.key(0), jcfg))
    ref = jax_ref("train")
    got = run_ranks(_ranked, (2, 4), ("data", "model"), tcfg, jp,
                    ref["batch"], (1, 2))

    # the port on one process
    params = params_from_jax(jp, tcfg, device="cpu")
    opt = init_opt_state(params)
    step = make_train_step(tcfg, AdamWConfig(warmup_steps=1))
    params, opt, metrics = step(params, opt, _batch(ref["batch"]))

    one = got[1]
    assert abs(one["metrics"]["loss"] - ref["loss"]) < 1e-5
    assert abs(one["metrics"]["loss"] - float(metrics["loss"])) < 1e-5
    assert abs(one["metrics"]["grad_norm"]
               - float(metrics["grad_norm"])) < 1e-5
    # AdamW's first step moves each weight by about lr * sign(gradient): a
    # gradient near zero summed in another order may move its weight
    # differently, so the parameters are held to 1e-4 (lr is 3e-4)
    for a, b in zip(leaves(one["params"]), leaves(params), strict=True):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
    # against the JAX package's step, in its stacked tree
    mine = jax.tree.leaves(params_to_jax(one["params"], tcfg))
    theirs = jax.tree.leaves(ref["params"])
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs, strict=True):
        np.testing.assert_allclose(a, b, rtol=0, atol=5e-3)

    # two microbatches equal one
    two = got[2]
    assert abs(two["metrics"]["loss"] - one["metrics"]["loss"]) < 1e-5
    for a, b in zip(leaves(two["params"]), leaves(one["params"]),
                    strict=True):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
    # the gradients went through reduce-scatters into the moments' layout
    assert one["counts"]["reduce-scatter"]["calls"] > 0


def test_moments_follow_zero1():
    """Rank 0's moment shards: the parameter's shard cut once more over
    the data axis, on the dim `opt_state_shardings` names."""
    _, tcfg = config_pair("gemma-2b", **REDUCED)
    ctx = PAR.ParallelContext(mesh=PAR.Mesh((2, 4), ("data", "model"),
                                            rank=0))
    shapes = M.params_shapes(tcfg)
    params = PAR.shard_params(M.init_params(tcfg, device="cpu"), ctx)
    opt = init_opt_state_sharded(params, tcfg, ctx)
    mspecs = PAR.opt_state_shardings(shapes, ctx)
    cut = 0

    def check(m, spec, full):
        nonlocal cut
        assert tuple(m.shape) == PAR.local_shape(full.shape, spec, ctx)
        cut += "data" in spec
    PAR.map_trees(check, opt.m, mspecs, shapes)
    assert cut > 0
