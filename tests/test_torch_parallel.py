"""The port's sharding rules against the JAX package's, leaf for leaf.

For every assigned architecture at full width, on the production meshes
(16, 16) and (2, 16, 16) and on the (2, 4) test mesh: parameter specs, the
ZeRO-1 moment specs, cache specs (batch 128 x 32768 with and without
context parallelism, batch 1 x 524288) and batch specs. The JAX side runs
on a ``jax.sharding.AbstractMesh`` (no devices), the port's on
``Mesh.abstract`` (shapes alone). The JAX package stacks each superblock
position's layers along a leading axis; the port keeps one dict per layer,
so a port leaf is compared with the JAX leaf's spec without that axis.
"""
import functools
import math

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro.configs import ASSIGNED_ARCHS, INPUT_SHAPES
from repro.configs import get_config as jax_get_config
from repro.launch import shardings as jsh
from repro.models import model as JM
from repro.models import parallel as jpar
from repro_torch.configs import get_config
from repro_torch.launch import shardings as tsh
from repro_torch.models import model as TM
from repro_torch.models import parallel as tpar
from repro_torch.models.transformer import block_program

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "2x4": ((2, 4), ("data", "model")),
}


def _contexts(mesh_name):
    shape, names = MESHES[mesh_name]
    baxes = ("pod", "data") if "pod" in names else ("data",)
    jctx = jpar.ParallelContext(mesh=AbstractMesh(shape, names),
                                batch_axes=baxes, model_axis="model")
    tctx = tpar.ParallelContext(mesh=tpar.Mesh.abstract(shape, names),
                                batch_axes=baxes, model_axis="model")
    return jctx, tctx


def _norm(spec, ndim):
    """A JAX PartitionSpec (or NamedSharding) as the port's tuple."""
    spec = getattr(spec, "spec", spec)
    out = tuple(tuple(e) if isinstance(e, list) else e for e in spec)
    return out + (None,) * (ndim - len(out))


def _jax_leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(
        x, (P, jax.sharding.NamedSharding)))


def _per_layer(jstack, cfg):
    """The JAX {"head", "sb", "tail"} tree as one tree per layer in
    execution order; a superblock leaf keeps its stacked dim (index 0)."""
    prog = block_program(cfg)
    out = [(t, False) for t in jstack["head"]]
    for _ in range(prog.n_superblocks):
        out += [(t, True) for t in jstack["sb"]]
    out += [(t, False) for t in jstack["tail"]]
    return out


def _compare_layers(port_layers, jax_spec_stack, jax_shape_stack, cfg,
                    skip_stack_dim_entry=False):
    """Each port layer's specs against the JAX layer's, leaf for leaf."""
    jl = _per_layer(jax_spec_stack, cfg)
    js = _per_layer(jax_shape_stack, cfg)
    assert len(port_layers) == len(jl)
    n = 0
    for tl, (jspec, stacked), (jshape, _) in zip(port_layers, jl, js,
                                                 strict=True):
        tleaves = _flat(tl)
        jspecs = _jax_leaves(jspec)
        jshapes = jax.tree.leaves(jshape)
        assert len(tleaves) == len(jspecs) == len(jshapes)
        for t, j, shp in zip(tleaves, jspecs, jshapes, strict=True):
            j = _norm(j, len(shp.shape))
            if stacked:
                if skip_stack_dim_entry and j[0] is not None:
                    continue        # the JAX rule chose the stacked dim
                assert j[0] is None or skip_stack_dim_entry
                j = j[1:]
            assert t == j, (t, j)
            n += 1
    return n


def _flat(tree):
    """Spec leaves of a port tree, dict keys sorted (JAX's order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _flat(v)]
    return [tree]


@functools.lru_cache(maxsize=None)
def _jax_param_shapes(arch):
    return JM.params_shapes(jax_get_config(arch))


def _sds_tree(tree):
    """The port's meta tree as JAX ShapeDtypeStructs (same structure)."""
    if isinstance(tree, dict):
        return {k: _sds_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_sds_tree(v) for v in tree]
    return jax.ShapeDtypeStruct(tuple(tree.shape), jnp.float32)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_and_moment_specs_match_jax(arch, mesh_name):
    jctx, tctx = _contexts(mesh_name)
    cfg = get_config(arch)
    tshapes = TM.params_shapes(cfg)
    jshapes = _jax_param_shapes(arch)

    tspecs = tpar.param_specs(tshapes, tctx)
    jspecs = jpar.param_specs(jshapes, jctx)
    # top-level leaves (embed, final_norm, unembed, encoder, vision_proj)
    for key in tshapes:
        if key == "layers":
            continue
        if key == "encoder":
            enc = jspecs["encoder"]
            tl = [(_flat(x)) for x in tspecs["encoder"]["layers"]]
            jl = _jax_leaves(enc["layers"])
            jsh = jax.tree.leaves(jshapes["encoder"]["layers"])
            for layer in tl:
                for t, j, s in zip(layer, jl, jsh, strict=True):
                    assert t == _norm(j, len(s.shape))[1:]
            assert _flat(tspecs["encoder"]["norm"]) == [
                _norm(j, 1) for j in _jax_leaves(enc["norm"])]
            continue
        tl, jl = _flat(tspecs[key]), _jax_leaves(jspecs[key])
        sh = jax.tree.leaves(jshapes[key])
        assert tl == [_norm(j, len(s.shape))
                      for j, s in zip(jl, sh, strict=True)], key
    n = _compare_layers(tspecs["layers"], jspecs["stack"], jshapes["stack"],
                        cfg)
    assert n > 0

    # ZeRO-1 moments: the JAX rule on the port's (per-layer) tree is the
    # port's rule, exactly ...
    tmom = tpar.opt_state_shardings(tshapes, tctx)
    jmom = jpar.opt_state_shardings(_sds_tree(tshapes), jctx)
    tl = _flat(tmom)
    jl = [_norm(j, len(s.shape)) for j, s in zip(
        _jax_leaves(jmom), jax.tree.leaves(_sds_tree(tshapes)), strict=True)]
    assert tl == jl
    # ... and equals the JAX package's own stacked tree wherever that put
    # the data axes on a dim the port's leaf has
    jmom_stack = jpar.opt_state_shardings(jshapes, jctx)
    _compare_layers(tmom["layers"], jmom_stack["stack"], jshapes["stack"],
                    cfg, skip_stack_dim_entry=True)


CACHE_CASES = [(128, 32768, False), (128, 32768, True), (1, 524288, True)]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_cache_and_batch_specs_match_jax(arch, mesh_name):
    jctx, tctx = _contexts(mesh_name)
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for batch, max_seq, cp in CACHE_CASES:
        tspec = tsh.cache_specs_tree(cfg, tctx, batch, max_seq, cp)
        jspec = jsh.cache_specs_tree(jcfg, jctx, batch, max_seq, cp)
        jshape = jax.eval_shape(lambda b=batch, s=max_seq: JM.init_cache(
            jcfg, b, s))
        assert _compare_layers(tspec, jspec, jshape, cfg) > 0
    for name, shape in INPUT_SHAPES.items():
        tb = tsh.batch_shardings(cfg, tctx, shape)
        jb = jsh.batch_shardings(jcfg, jctx, shape)
        jin = JM.input_specs(jcfg, shape)
        assert set(tb) == set(jb), name
        for k in tb:
            assert tb[k] == _norm(jb[k], len(jin[k].shape)), (name, k)


@pytest.mark.parametrize("arch", ["gemma-2b", "deepseek-moe-16b",
                                  "mamba2-2.7b", "minicpm3-4b"])
def test_shard_params_local_shapes_follow_specs(arch):
    """`shard_params` keeps, on every rank of (2, 4), the slice its specs
    give: local shapes divide by the axis sizes, and the model-axis shards
    of a leaf tile the whole leaf."""
    cfg = get_config(arch).reduced()
    full = TM.init_params(cfg, seed=0, device="cpu")
    shape, names = MESHES["2x4"]
    specs = None
    pieces = {}
    for rank in range(8):
        ctx = tpar.ParallelContext(mesh=tpar.Mesh(shape, names, rank=rank))
        specs = tpar.param_specs(full, ctx)
        local = tpar.shard_params(full, ctx)
        for t, s, f in zip(_flat(local), _flat(specs), _flat(full),
                           strict=True):
            assert tuple(t.shape) == tpar.local_shape(f.shape, s, ctx)
        pieces[rank] = _flat(local)
    sharded = 0
    for i, (s, f) in enumerate(zip(_flat(specs), _flat(full), strict=True)):
        if "model" not in s:
            for r in range(8):
                torch.testing.assert_close(pieces[r][i], f)
            continue
        sharded += 1
        dim = s.index("model")
        whole = torch.cat([pieces[r][i] for r in range(4)], dim=dim)
        torch.testing.assert_close(whole, f)
    assert sharded > 0


@pytest.mark.parametrize("mesh_name", list(MESHES) + ["2x2"])
@pytest.mark.parametrize("arch", [a for a in ASSIGNED_ARCHS
                                  if a != "mamba2-2.7b"])
def test_sharded_attention_fits_the_kernels(arch, mesh_name):
    """Every rank's q-heads a kv-head and head_dim, after sharding at full
    width, are ones the flash and decode kernels take (Mamba-2 has no
    attention; an MLA layer runs flash on the rank's heads at head_dim
    nope + rope)."""
    from repro_torch.models import tp
    shape, names = MESHES.get(mesh_name, ((2, 2), ("data", "model")))
    cfg = get_config(arch)
    for rank in (0, math.prod(shape) - 1):
        ctx = tpar.ParallelContext(
            mesh=tpar.Mesh(shape, names, rank=rank),
            batch_axes=("pod", "data") if "pod" in names else ("data",))
        tp.check_kernel_shapes(cfg, ctx)


def test_placements_and_context_helpers():
    """`param_placements` turns each spec into one placement per mesh
    axis; the context's helpers cut a tensor held whole the way its spec
    says, and leave it whole without a mesh or where the batch does not
    divide the data axes."""
    from torch.distributed.tensor import Replicate, Shard
    shape, names = MESHES["2x16x16"]
    mesh = tpar.Mesh(shape, names, rank=5)
    ctx = tpar.ParallelContext(mesh=mesh, batch_axes=("pod", "data"))
    assert tpar.param_placements(("model", None), mesh) == (
        Replicate(), Replicate(), Shard(0))
    assert tpar.param_placements((("pod", "data"), "model"), mesh) == (
        Shard(0), Shard(0), Shard(1))
    specs = tpar.param_specs(TM.params_shapes(get_config("gemma-2b")), ctx)
    placed = tpar.param_placements(specs, mesh)
    assert placed["embed"] == (Replicate(), Replicate(), Shard(0))
    assert placed["layers"][0]["mlp"]["w_down"] == (
        Replicate(), Replicate(), Shard(0))

    x = torch.arange(64 * 3).reshape(64, 3)
    # rank 5 of (2, 16, 16): pod 0, data 0, model 5 -> rows 0..1
    torch.testing.assert_close(ctx.shard_batch(x), x[:2])
    assert ctx.shard_batch(x[:3]).shape == (3, 3)        # 3 rows: whole
    torch.testing.assert_close(ctx.constrain(x.t(), None, "model"),
                               x.t()[:, 20:24])
    assert ctx.shard_activation(x) is x
    assert ctx.batch_size_divisor == 32 and ctx.model_size == 16
    assert ctx.model_spec_if(48) == "model" and ctx.model_spec_if(40) is None
    none = tpar.cpu_context()
    assert none.shard_batch(x) is x and none.constrain(x, "model") is x
