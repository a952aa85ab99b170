"""The JAX package's sharded runs, as references for the port's.

Run as ``python tests/test_torch_dist_jaxref.py CASE OUT.pkl [IN.npz]`` in a
process of its own with ``XLA_FLAGS=--xla_force_host_platform_device_count=8``
(the device count is fixed when JAX starts). The mesh is (2, 4)
``('data', 'model')`` with ``AxisType.Auto`` axes: ``jax.make_mesh`` makes
Explicit axes by default in this JAX, and ``with_sharding_constraint``
refuses those. Weights come from ``init_params(jax.random.key(0))``, which
the test process draws too; inputs come from IN.npz. The outputs are
pickled numpy arrays.
It holds no tests of its own: the sharded tests import it.
"""
import dataclasses
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P

from repro.configs import get_config
from repro.models import (cpu_context, decode_step, dummy_batch, init_cache,
                          init_params, params_shapes, prefill)
from repro.models.parallel import ParallelContext, param_shardings


def mesh_ctx(**kw):
    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    return mesh, ParallelContext(mesh=mesh, batch_axes=("data",),
                                 model_axis="model", **kw)


def f32(arch, **reduced):
    return dataclasses.replace(get_config(arch).reduced(**reduced),
                               dtype="float32")


def cp_decode(inp):
    """Prefill, then scalar-`pos` decode steps, on the mesh (the CP path
    where the kv-heads do not divide the model axis)."""
    out = {}
    for arch, max_seq in (("gemma-2b", 32), ("gemma3-12b", 192)):
        cfg = f32(arch)
        params = init_params(jax.random.key(0), cfg)
        toks = jnp.asarray(inp[arch])
        b, total = toks.shape
        s = total - 3
        _, ctx = mesh_ctx()
        cache = init_cache(cfg, b, max_seq)
        last, cache = prefill(params, {"tokens": toks[:, :s]}, cache,
                              cfg=cfg, ctx=ctx)
        step = jax.jit(lambda p, t, c, pos, cfg=cfg, ctx=ctx: decode_step(
            p, t, c, pos, cfg=cfg, ctx=ctx))
        logits = [np.asarray(last)]
        for i in range(3):
            lg, cache = step(params, toks[:, s + i:s + i + 1], cache,
                             jnp.int32(s + i))
            logits.append(np.asarray(lg))
        out[arch] = np.stack(logits)
    return out


PROMPTS = [[5, 9, 23, 7], [100, 3, 44, 12, 77, 8, 2], [31, 32, 33]]
MAX_NEW = 6


def engine(inp):
    """Greedy tokens of the JAX engine under the mesh."""
    from repro.serving.engine import ServingEngine
    out = {}
    for arch in ("gemma-2b", "deepseek-moe-16b"):
        cfg = f32(arch)
        params = init_params(jax.random.key(0), cfg)
        _, ctx = mesh_ctx()
        eng = ServingEngine(cfg, params, max_batch=4, max_seq=64, ctx=ctx)
        reqs = [eng.submit(p, max_new_tokens=MAX_NEW) for p in PROMPTS]
        eng.run_until_idle()
        out[arch] = [list(r.generated) for r in reqs]
    return out


def ep_a2a(inp):
    """moe_layer_ep_a2a on the mesh against dense dispatch."""
    from repro.models.moe import init_moe, moe_layer, moe_layer_ep_a2a
    cfg = f32("deepseek-moe-16b")
    key = jax.random.key(0)
    p = init_moe(key, cfg)
    x = jnp.asarray(inp["x"])
    _, ctx = mesh_ctx()
    dense, _ = moe_layer(p, x, cfg=cfg, ctx=cpu_context())
    o, aux = jax.jit(lambda p, x: moe_layer_ep_a2a(
        p, x, cfg=cfg, ctx=ctx, capacity_factor=8.0))(p, x)
    return {"dense": np.asarray(dense), "ep": np.asarray(o),
            "aux": np.asarray(aux["moe_aux_loss"])}


def train(inp):
    """One sharded train step of reduced gemma-2b, as
    tests/test_distribution.py runs it."""
    from repro.training import AdamWConfig, init_opt_state, make_train_step
    cfg = get_config("gemma-2b").reduced(n_layers=2, d_model=128,
                                         vocab_size=512)
    cfg = dataclasses.replace(cfg, dtype="float32")
    mesh, ctx = mesh_ctx()
    params = init_params(jax.random.key(0), cfg)
    params = jax.device_put(params, param_shardings(params_shapes(cfg), ctx))
    opt = init_opt_state(params)
    step = jax.jit(make_train_step(cfg, ctx, AdamWConfig(warmup_steps=1)))
    batch = dummy_batch(jax.random.key(1), cfg, 4, 32, "train")
    host_batch = jax.tree.map(np.asarray, batch)
    batch = jax.device_put(batch, NamedSharding(mesh, P("data", None)))
    params, opt, metrics = step(params, opt, batch)
    return {"batch": host_batch, "loss": float(metrics["loss"]),
            "params": jax.tree.map(np.asarray, params)}


# the Mamba-2, RG-LRU, MLA and M-RoPE families' sharded engines, the
# sharded paged engine, and whisper-base at the model level
FAMILIES = ("mamba2-2.7b", "recurrentgemma-2b", "minicpm3-4b", "qwen2-vl-2b")
PAGED = ("gemma-2b", "mamba2-2.7b")
PAGED_NEW = 10
WHISPER_ROWS, WHISPER_PROMPT, WHISPER_FRAMES, WHISPER_SLOTS = 4, 8, 24, 32


def paged_prompts(block_tokens: int = 16):
    """Three prompts; the second opens with the first one's two full
    blocks (a prefix hit where the cache is all pages)."""
    head = [(5 * j + 2) % 512 for j in range(2 * block_tokens)]
    return [head + [9, 8, 7, 6, 5], head + [1, 2, 3], [4, 5, 6, 7, 8, 9]]


def evict_resume(eng, prompts, new: int, steps: int = 3):
    """Serve `prompts` on a paged engine, evicting the first request after
    `steps` steps and resubmitting it once the others are admitted (it
    resumes in another slot). Returns every request's tokens."""
    reqs = [eng.submit(prompts[0], max_new_tokens=new)]
    for _ in range(steps):
        eng.step()
    victim = eng.evict(reqs[0].slot)
    assert victim is reqs[0] and victim.kv is not None
    reqs += [eng.submit(p, max_new_tokens=new) for p in prompts[1:]]
    eng.step()
    eng.resubmit(victim)
    eng.run_until_idle()
    return [list(r.generated) for r in reqs]


def families(inp):
    """On the mesh: the greedy tokens of the families' engines and of the
    paged engines (an eviction, a resume and a prefix hit), and whisper's
    prefill and decode logits."""
    from repro.serving.engine import ServingEngine
    out = {"engine": {}, "paged": {}}
    for arch in FAMILIES:
        cfg = f32(arch)
        params = init_params(jax.random.key(0), cfg)
        _, ctx = mesh_ctx()
        eng = ServingEngine(cfg, params, max_batch=4, max_seq=64, ctx=ctx)
        reqs = [eng.submit(p, max_new_tokens=MAX_NEW) for p in PROMPTS]
        eng.run_until_idle()
        out["engine"][arch] = [list(r.generated) for r in reqs]
    for arch in PAGED:
        cfg = f32(arch)
        params = init_params(jax.random.key(0), cfg)
        _, ctx = mesh_ctx()
        eng = ServingEngine(cfg, params, max_batch=4, max_seq=64, ctx=ctx,
                            paged=True, kv_block_tokens=16)
        toks = evict_resume(eng, paged_prompts(), PAGED_NEW)
        out["paged"][arch] = (toks, eng.n_prefix_hits)
    cfg = f32("whisper-base")
    params = init_params(jax.random.key(0), cfg)
    _, ctx = mesh_ctx()
    toks = jnp.asarray(inp["whisper_tokens"])
    s = WHISPER_PROMPT
    cache = init_cache(cfg, WHISPER_ROWS, WHISPER_SLOTS)
    last, cache = prefill(params, {"tokens": toks[:, :s], "audio_frames":
                                   jnp.asarray(inp["whisper_frames"])},
                          cache, cfg=cfg, ctx=ctx)
    logits = [np.asarray(last)]
    for i in range(toks.shape[1] - s):
        lg, cache = decode_step(params, toks[:, s + i:s + i + 1], cache,
                                jnp.int32(s + i), cfg=cfg, ctx=ctx)
        logits.append(np.asarray(lg))
    out["whisper"] = np.stack(logits)
    return out


# sequence parallelism of the residual stream: (arch, config fields
# replaced in the reduced float32 config, ParallelContext fields, sequence
# length); the model axis of 4 divides every length but 18
SEQ_CASES = {
    "qwen2-vl-2b": ("qwen2-vl-2b", {}, {}, 16),
    "mamba2-2.7b": ("mamba2-2.7b", {}, {}, 16),
    "recurrentgemma-2b": ("recurrentgemma-2b", {}, {}, 16),
    "minicpm3-4b": ("minicpm3-4b", {}, {}, 16),
    "minicpm3-4b/6-heads": ("minicpm3-4b", {"n_heads": 6, "n_kv_heads": 6},
                            {}, 16),
    "deepseek-moe-16b/dense": ("deepseek-moe-16b", {}, {}, 16),
    "deepseek-moe-16b/capacity": ("deepseek-moe-16b", {},
                                  {"moe_dispatch": "capacity"}, 16),
    "deepseek-moe-16b/ep_a2a": ("deepseek-moe-16b", {},
                                {"moe_dispatch": "ep_a2a"}, 16),
    "deepseek-moe-16b/expert-parallel": (
        "deepseek-moe-16b", {}, {"moe_expert_parallel": True}, 16),
    "deepseek-moe-16b/f-126": ("deepseek-moe-16b", {"moe_d_ff": 126}, {},
                               16),
    "whisper-base": ("whisper-base", {}, {}, 16),
    "gemma-2b/s-18": ("gemma-2b", {}, {}, 18),
    "deepseek-moe-16b/capacity/s-18": ("deepseek-moe-16b", {},
                                       {"moe_dispatch": "capacity"}, 18),
}
SEQ_ROWS = 4
SEQ_ADAMW_EPS = 1e-6


def seq_config(name):
    arch, kw, _, _ = SEQ_CASES[name]
    return dataclasses.replace(f32(arch), **kw)


def seq_train(inp):
    """One sharded train step of each `SEQ_CASES` case whose batch IN.npz
    holds (under "<case>/<input>") on the mesh: its loss, grad_norm and
    parameters."""
    from repro.training import AdamWConfig, init_opt_state, make_train_step
    out = {}
    for name, (_, _, ctx_kw, _) in SEQ_CASES.items():
        if f"{name}/tokens" not in inp:
            continue
        cfg = seq_config(name)
        mesh, ctx = mesh_ctx(**ctx_kw)
        params = init_params(jax.random.key(0), cfg)
        params = jax.device_put(params,
                                param_shardings(params_shapes(cfg), ctx))
        opt = init_opt_state(params)
        step = jax.jit(make_train_step(
            cfg, ctx, AdamWConfig(warmup_steps=1, eps=SEQ_ADAMW_EPS)))
        batch = {}
        for key, v in inp.items():
            case, _, field = key.rpartition("/")
            if case == name:
                spec = P(None, "data") if field == "positions" else P("data")
                batch[field] = jax.device_put(jnp.asarray(v),
                                              NamedSharding(mesh, spec))
        params, opt, metrics = step(params, opt, batch)
        out[name] = {"loss": float(metrics["loss"]),
                     "grad_norm": float(metrics["grad_norm"]),
                     "params": jax.tree.map(np.asarray, params)}
    return out


CASES = {"cp_decode": cp_decode, "engine": engine, "ep_a2a": ep_a2a,
         "train": train, "families": families, "seq_train": seq_train}


if __name__ == "__main__":
    case, out_path = sys.argv[1], sys.argv[2]
    inp = dict(np.load(sys.argv[3], allow_pickle=True)) \
        if len(sys.argv) > 3 else {}
    assert len(jax.devices()) == 8, jax.devices()
    res = CASES[case](inp)
    with open(out_path, "wb") as f:
        pickle.dump(res, f)
