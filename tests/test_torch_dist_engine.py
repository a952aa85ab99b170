"""The port's sharded serving engine on 8 gloo ranks.

A (2, 4) ``('data', 'model')`` mesh of processes on the CPU
(`test_torch_dist_harness.run_ranks`): every rank runs the engine over its shards
(weights, the slot cache, its slot rows), and its greedy tokens must equal
the JAX engine's under the same mesh (`test_torch_dist_jaxref.py`, 8 host
devices) and the port's single-process engine's. Reduced float32 gemma-2b
decodes through the context-parallel path (one kv-head on a model axis of
4); reduced deepseek-moe-16b through tensor-parallel attention and the
dense MoE dispatch on the rank's expert columns.
"""
import jax

from test_torch_dist_jaxref import MAX_NEW, PROMPTS
from test_torch_dist_harness import jax_ref, run_ranks
from _torch_parity import config_pair, numpy_tree
from repro.models import init_params as jax_init_params
from repro_torch.models import parallel as PAR
from repro_torch.models.convert import params_from_jax
from repro_torch.serving.engine import ServingEngine


def _weights(arch):
    jcfg, tcfg = config_pair(arch)
    return tcfg, numpy_tree(jax_init_params(jax.random.key(0), jcfg))


def _serve(tcfg, params, ctx=None):
    eng = ServingEngine(tcfg, params, max_batch=4, max_seq=64, device="cpu",
                        ctx=ctx)
    reqs = [eng.submit(p, max_new_tokens=MAX_NEW) for p in PROMPTS]
    eng.run_until_idle()
    return [list(r.generated) for r in reqs]


def _ranked_engine(ctx, weights):
    out = {}
    for arch, (tcfg, jp) in weights.items():
        params = PAR.shard_params(params_from_jax(jp, tcfg, device="cpu"),
                                  ctx)
        out[arch] = _serve(tcfg, params, ctx)
    return out


def test_sharded_engine_matches_jax_engine_on_the_mesh():
    archs = ("gemma-2b", "deepseek-moe-16b")
    weights = {arch: _weights(arch) for arch in archs}
    ref = jax_ref("engine")
    got = run_ranks(_ranked_engine, (2, 4), ("data", "model"), weights)
    for arch in archs:
        tcfg, jp = weights[arch]
        single = _serve(tcfg, params_from_jax(jp, tcfg, device="cpu"))
        assert got[arch] == ref[arch] == single, arch
