"""Device choice, meshes, parameter sharding rules and collectives.

All model code is written against a ``ParallelContext``, as in the JAX
package. With ``ctx=None`` (or a context without a mesh) every model
function runs the single-device path unchanged. Under a mesh each rank
holds *local shards* of the parameters, caches and batches (the Megatron
form): the sharding follows the JAX package's name-based rules
(`spec_for_param`, `param_specs`, `opt_state_shardings`), kept here as plain
spec trees (per leaf, a tuple of mesh-axis names or None per dim), and the
model code issues the collectives that GSPMD inserts for the JAX package
(an all-reduce after a row-parallel product, or, where the residual stream
is split over the sequence, an all-gather of the sequence before a layer
and a reduce-scatter after it; an all-gather of a vocabulary-parallel head,
the context-parallel decode's combine, the expert-parallel all-to-alls).
Every collective goes through one set of helpers below, which count calls
and result bytes by kind (`collective_counts`); those read by the dry run
and ``chip_smoke.py``.

A `Mesh` is axis names and sizes, this rank's coordinate along each axis
and a process group per axis and per set of axes. ``init_mesh`` builds it on
the process group the caller set up (``torch.distributed``), through
``init_device_mesh``; ``Mesh.abstract`` gives the shapes alone, which is
enough for the spec trees. The caller names the backend: NCCL where each
rank has its own card, gloo where ranks share a card or run on the CPU.
A collective that the backend refuses raises.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import warnings
from typing import Dict, Optional, Sequence, Tuple, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is asked for (or defaulted to) and there is
    no card: the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


# ---------------------------------------------------------------------------
# Meshes
# ---------------------------------------------------------------------------

Axes = Union[str, Tuple[str, ...]]


def _as_axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Mesh:
    """Named mesh axes over the ranks of a process group (row-major, as
    ``jax.make_mesh``), or over no group at all (`abstract`)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 rank: int = 0, groups: Optional[dict] = None,
                 backend: Optional[str] = None, device_mesh=None):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and names {axis_names}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape, strict=True))
        self.rank = rank
        self.backend = backend
        self.device_mesh = device_mesh
        self._groups = groups or {}
        idx, rest = {}, rank
        for name in reversed(self.axis_names):
            idx[name] = rest % self.shape[name]
            rest //= self.shape[name]
        self._coord = idx

    @classmethod
    def abstract(cls, shape: Sequence[int], axis_names: Sequence[str]):
        """Shapes alone: enough for spec trees, no collectives."""
        return cls(shape, axis_names)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def devices_shape(self) -> Tuple[int, ...]:
        return tuple(self.shape[a] for a in self.axis_names)

    def axes_size(self, axes: Axes) -> int:
        return math.prod(self.shape[a] for a in _as_axes(axes))

    def index(self, axes: Axes) -> int:
        """This rank's index along `axes` (row-major over several)."""
        out = 0
        for a in _as_axes(axes):
            out = out * self.shape[a] + self._coord[a]
        return out

    def group(self, axes: Axes):
        key = tuple(a for a in self.axis_names if a in _as_axes(axes))
        if key not in self._groups:
            raise RuntimeError(f"mesh has no process group for {key}; build "
                               f"it with init_mesh")
        return self._groups[key]


def init_mesh(shape: Sequence[int], axis_names: Sequence[str], *,
              backend: str, device_type: Optional[str] = None) -> Mesh:
    """A mesh over the process group the caller initialised
    (``torch.distributed.init_process_group`` with this ``backend``: "nccl"
    with one card a rank, "gloo" where ranks share a card or run on the
    CPU, "fake" for the dry run). Builds ``init_device_mesh`` and one
    process group for every set of axes (every rank takes part in every
    ``new_group`` call, in the same order)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape, names = tuple(shape), tuple(axis_names)
    if not dist.is_initialized():
        raise RuntimeError("init_process_group first: init_mesh shards over "
                           "the caller's process group")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, the "
                         f"group has {world}")
    dtype = device_type or ("cuda" if backend == "nccl" else "cpu")
    dmesh = init_device_mesh(dtype, shape, mesh_dim_names=names)
    ranks = torch.arange(world).reshape(shape)
    rank = dist.get_rank()
    groups = {}
    for n in range(1, len(names) + 1):
        for sub in itertools.combinations(range(len(names)), n):
            key = tuple(names[i] for i in sub)
            if n == 1:
                groups[key] = dmesh.get_group(key[0])
                continue
            if n == len(names):
                groups[key] = dist.group.WORLD
                continue
            # move the axes of `sub` last and enumerate the other coords
            perm = [i for i in range(len(names)) if i not in sub] + list(sub)
            flat = ranks.permute(perm).reshape(-1, math.prod(
                shape[i] for i in sub))
            for row in flat.tolist():
                g = dist.new_group(row)
                if rank in row:
                    groups[key] = g
    return Mesh(shape, names, rank=rank, groups=groups, backend=backend,
                device_mesh=dmesh)


# ---------------------------------------------------------------------------
# The context
# ---------------------------------------------------------------------------

Spec = Tuple[Optional[Axes], ...]


@dataclasses.dataclass(frozen=True)
class ParallelContext:
    mesh: Optional[Mesh] = None
    batch_axes: Tuple[str, ...] = ("data",)   # ("pod", "data") on multi-pod
    model_axis: Optional[str] = "model"
    cp_axis: Optional[str] = None   # context-parallel axis for long-KV decode
    remat: bool = True              # activation checkpointing in train_step
    moe_expert_parallel: bool = False
    moe_dispatch: str = "dense"     # dense | capacity | ep_a2a
    # the residual stream a layer takes is this rank's slice of the
    # sequence (set for one forward by `sequence_parallel`)
    seq_sharded: bool = False

    # ------------------------------------------------------------------
    def axis_size(self, name: Optional[Axes]) -> int:
        if self.mesh is None or name is None:
            return 1
        return self.mesh.axes_size(name)

    def axis_index(self, name: Optional[Axes]) -> int:
        if self.mesh is None or name is None:
            return 0
        return self.mesh.index(name)

    @property
    def batch_size_divisor(self) -> int:
        out = 1
        for a in self.batch_axes:
            out *= self.axis_size(a)
        return out

    @property
    def batch_spec(self):
        """Spec entry that shards a batch dimension."""
        return self.batch_axes if len(self.batch_axes) > 1 \
            else self.batch_axes[0]

    @property
    def model_size(self) -> int:
        return self.axis_size(self.model_axis)

    def model_spec_if(self, dim_size: int):
        """'model' if dim divisible by the model-axis size, else None."""
        m = self.axis_size(self.model_axis)
        if m > 1 and dim_size % m == 0:
            return self.model_axis
        return None

    def batch_sharded(self, b: int) -> bool:
        """Whether a global batch of `b` rows is split over the data axes."""
        d = self.batch_size_divisor
        return self.mesh is not None and d > 1 and b % d == 0

    def shard_batch(self, x, dim: int = 0):
        """This rank's rows of a global batch tensor (dim `dim`), when the
        batch divides the data axes; else the tensor as it is (replicated,
        as the JAX package leaves an indivisible batch)."""
        if self.mesh is None or not self.batch_sharded(x.shape[dim]):
            return x
        return local_view(x, _spec_at(x.ndim, dim, self.batch_spec), self)

    def seq_splits(self, s: int) -> bool:
        """The JAX package's rule for sequence parallelism: a sequence of
        `s` > 1 tokens that the model axis (of size > 1) divides."""
        m = self.model_size
        return self.mesh is not None and m > 1 and s > 1 and s % m == 0

    def sequence_parallel(self, s: int) -> "ParallelContext":
        """This context for one forward over `s` tokens: ``seq_sharded``
        where `seq_splits` holds (the residual stream between the blocks is
        then this rank's (B, S/m, D) slice, Megatron's sequence
        parallelism), else held whole on every model rank."""
        return dataclasses.replace(self, seq_sharded=self.seq_splits(s))

    def shard_activation(self, x):
        """(B, S, D) activations at residual boundaries, held the same on
        every model rank: this rank's slice of the sequence where
        `seq_splits` holds, taken locally (the backward all-gathers the
        gradient); else x. The JAX package constrains the sequence over
        ``model`` here, so that the residual saved per layer for the
        backward costs 1/m of the replicated footprint; the layers then
        gather the sequence before their column-parallel products and
        reduce-scatter their row-parallel partial sums
        (`gather_seq`, `scatter_seq`)."""
        if self.mesh is None or x.ndim != 3 \
                or not self.seq_splits(x.shape[1]):
            return x
        return split(x, self, self.model_axis, 1)

    def constrain(self, x, *spec):
        """The local shard of a tensor held whole on this rank, along
        `spec` (no communication; the inverse is `all_gather`)."""
        if self.mesh is None:
            return x
        return local_view(x, tuple(spec) + (None,) * (x.ndim - len(spec)),
                          self)


def cpu_context(**kw) -> ParallelContext:
    return ParallelContext(mesh=None, batch_axes=(), model_axis=None, **kw)


def is_sharded(ctx: Optional[ParallelContext]) -> bool:
    """Whether `ctx` asks for the sharded path (None and mesh-less
    contexts run the single-device path)."""
    return ctx is not None and ctx.mesh is not None


def _spec_at(ndim: int, dim: int, entry) -> Spec:
    spec = [None] * ndim
    spec[dim] = entry
    return tuple(spec)


def local_view(x, spec: Spec, ctx: ParallelContext):
    """The slice of the whole tensor `x` that this rank holds under
    `spec` (a view)."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        n = ctx.axis_size(entry)
        if n == 1:
            continue
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"over {entry} ({n})")
        c = x.shape[dim] // n
        x = x.narrow(dim, ctx.axis_index(entry) * c, c)
    return x


def local_shape(shape: Sequence[int], spec: Spec,
                ctx: ParallelContext) -> Tuple[int, ...]:
    return tuple(s // ctx.axis_size(e) if e is not None else s
                 for s, e in zip(shape, tuple(spec) + (None,) * (
                     len(shape) - len(spec)), strict=True))


# ---------------------------------------------------------------------------
# Name-based parameter sharding rules (tensor parallelism over "model")
# ---------------------------------------------------------------------------

# Column-parallel projections shard their output dim, row-parallel ones their
# input dim, so that product chains need no resharding (Megatron layout).
_COL_PARALLEL = {
    "wq", "wk", "wv", "w_up", "w_gate", "wq_b", "wkv_b", "wx", "wz",
    "w_rec_in", "w_gate_in",
}
_ROW_PARALLEL = {"wo", "w_down", "out_proj"}
_VOCAB_PARALLEL = {"embed", "unembed"}
_EXPERT_STACKED_COL = {"we_up", "we_gate"}   # (E, D, F): shard F
_EXPERT_STACKED_ROW = {"we_down"}            # (E, F, D): shard F


def spec_for_param(name: Optional[str], ndim: int) -> Spec:
    """The spec of one parameter leaf by name and rank, before the
    divisibility check (`param_specs` downgrades)."""
    if name is None or ndim == 0:
        return ()
    spec = [None] * ndim
    if name in _VOCAB_PARALLEL and ndim >= 2:
        spec[ndim - 2] = "model"
    elif name in _COL_PARALLEL or name in _EXPERT_STACKED_COL:
        spec[ndim - 1] = "model"
    elif name in _ROW_PARALLEL or name in _EXPERT_STACKED_ROW:
        spec[ndim - 2] = "model"
    return tuple(spec)


def map_with_name(fn, tree, name=None):
    """`fn(name, leaf)` over a tree of dicts and lists, where `name` is the
    nearest dict key above the leaf."""
    if isinstance(tree, dict):
        return {k: map_with_name(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_name(fn, v, name) for v in tree)
    return fn(name, tree)


def map_trees(fn, *trees):
    """`fn(leaf, leaf, ...)` over trees of the same structure (the first
    decides it)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: map_trees(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(map_trees(fn, *(t[i] for t in trees))
                           for i in range(len(first)))
    return fn(*trees)


def is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, (str, tuple)) for e in x)


def param_specs(params_shapes, ctx: ParallelContext):
    """Spec tree of a parameter (or shapes) tree: `spec_for_param`, with
    every entry whose dim does not divide its axes downgraded to None."""

    def fix(name, leaf):
        shape = tuple(leaf.shape)
        if ctx.mesh is None:
            return (None,) * len(shape)
        spec = spec_for_param(name, len(shape))
        out = [e if e is not None and shape[d] % ctx.axis_size(e) == 0
               else None for d, e in enumerate(spec)]
        return tuple(out + [None] * (len(shape) - len(out)))

    return map_with_name(fix, params_shapes)


def opt_state_shardings(params_shapes, ctx: ParallelContext):
    """ZeRO-1 specs of the AdamW moments (a spec tree; the JAX package's
    function of this name returns NamedShardings): the parameter's spec
    plus the data axes on its first further dim that they divide (AdamW is
    elementwise, so the moments are never gathered; the updated parameter
    is, once a step)."""
    specs = param_specs(params_shapes, ctx)
    if ctx.mesh is None:
        return specs
    dsize = ctx.batch_size_divisor

    def widen(leaf, spec):
        spec = list(spec)
        for dim, n in enumerate(leaf.shape):
            if spec[dim] is None and n % dsize == 0 and n >= dsize:
                spec[dim] = ctx.batch_spec
                break
        return tuple(spec)

    return map_trees(widen, params_shapes, specs)



def param_placements(specs, mesh: Mesh):
    """The DTensor placements a spec tree implies: per leaf, one
    ``Shard(dim)`` or ``Replicate()`` per mesh axis (the axes of a tuple
    entry shard the same dim, major first)."""
    from torch.distributed.tensor import Replicate, Shard

    def one(spec):
        out = [Replicate()] * len(mesh.axis_names)
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            for a in _as_axes(entry):
                out[mesh.axis_names.index(a)] = Shard(dim)
        return tuple(out)

    def walk(t):
        if is_spec(t):
            return one(t)
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return [walk(v) for v in t]

    return walk(specs)


class ShardedCache(list):
    """Per-layer cache dicts of this rank's shards, with ``specs``: the
    spec tree they were cut by (`launch.shardings.cache_specs_tree`)."""

    def __init__(self, layers, specs):
        super().__init__(layers)
        self.specs = specs


def shard_tree(tree, specs, ctx: ParallelContext, clone: bool = True):
    """Each leaf's local shard under its spec (a copy when ``clone``, so
    that the whole leaf can be freed)."""
    def one(x, spec):
        v = local_view(x, spec, ctx)
        return v.clone() if clone and v.device.type != "meta" else v
    return map_trees(one, tree, specs)


def shard_params(full_tree, ctx: ParallelContext):
    """The local shards of a whole parameter tree under `param_specs`."""
    return shard_tree(full_tree, param_specs(full_tree, ctx), ctx)


# ---------------------------------------------------------------------------
# Collectives: one helper per kind, counted, with autograd where the model
# differentiates through them
# ---------------------------------------------------------------------------

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")
_COUNTS: Dict[str, list] = {k: [0, 0, 0] for k in KINDS}


def reset_collectives() -> None:
    for k in KINDS:
        _COUNTS[k] = [0, 0, 0]


def collective_counts() -> dict:
    """{kind: {"calls", "bytes", "largest"}} since the last reset: the
    calls, their result bytes on this rank (the dry run counts an
    all-reduce twice, as the JAX package's ``collective_bytes`` does) and
    the largest result of one call."""
    return {k: {"calls": c, "bytes": b, "largest": m}
            for k, (c, b, m) in _COUNTS.items()}


def _count(kind: str, out: torch.Tensor) -> None:
    n = out.numel() * out.element_size()
    _COUNTS[kind][0] += 1
    _COUNTS[kind][1] += n
    _COUNTS[kind][2] = max(_COUNTS[kind][2], n)


def _run(kind: str, ctx: ParallelContext, fn, out, *ins):
    """Run ``fn(out, *ins)`` (a torch.distributed call writing `out`),
    counting it. Meta tensors (the dry run) only count."""
    _count(kind, out)
    if out.device.type == "meta":
        return out
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        fn(out, *ins)
    return out


def _group(ctx, axes):
    return ctx.mesh.group(axes)


def _reduce_op(op: str):
    import torch.distributed as dist
    return {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]


def _all_reduce_raw(x, ctx, axes, op="sum"):
    import torch.distributed as dist
    out = x.contiguous().clone()
    g, rop = _group(ctx, axes), _reduce_op(op)
    return _run("all-reduce", ctx,
                lambda o: dist.all_reduce(o, op=rop, group=g), out)


def _all_gather_raw(x, ctx, axes, dim):
    """The ranks' pieces concatenated along `dim`, contiguous (the kernels
    read the gathered K/V and q as they come)."""
    import torch.distributed as dist
    n = ctx.axis_size(axes)
    xc = x.contiguous()
    out = xc.new_empty((n * xc.shape[0],) + tuple(xc.shape[1:]))
    g = _group(ctx, axes)
    _run("all-gather", ctx,
         lambda o, i: dist.all_gather_into_tensor(o, i, group=g), out, xc)
    if dim == 0:
        return out
    return torch.cat(out.view((n,) + tuple(xc.shape)).unbind(0), dim=dim)


def _reduce_scatter_raw(x, ctx, axes, dim):
    import torch.distributed as dist
    n = ctx.axis_size(axes)
    xm = x.movedim(dim, 0).contiguous()
    out = xm.new_empty((xm.shape[0] // n,) + tuple(xm.shape[1:]))
    g = _group(ctx, axes)
    _run("reduce-scatter", ctx,
         lambda o, i: dist.reduce_scatter_tensor(o, i, group=g), out, xm)
    return out.movedim(0, dim).contiguous()


def _all_to_all_raw(x, ctx, axes, split_dim, concat_dim):
    """Split `split_dim` into n chunks, send chunk j to rank j of `axes`,
    and concatenate the chunks received along `concat_dim` (JAX's
    ``all_to_all(..., tiled=True)``)."""
    import torch.distributed as dist
    n = ctx.axis_size(axes)
    xm = x.movedim(split_dim, 0)
    xm = xm.reshape((n, xm.shape[0] // n) + tuple(xm.shape[1:])).contiguous()
    out = torch.empty_like(xm)
    g = _group(ctx, axes)
    _run("all-to-all", ctx,
         lambda o, i: dist.all_to_all_single(o, i, group=g), out, xm)
    # out[j] is rank j's chunk for this rank, its split dim first
    parts = [p.movedim(0, split_dim) for p in out.unbind(0)]
    return torch.cat(parts, dim=concat_dim)


class _AllReduce(torch.autograd.Function):
    """Sum over `axes`; the backward is the identity (the sum's consumers
    run the same on every rank of `axes`, Megatron's g)."""

    @staticmethod
    def forward(fctx, x, ctx, axes):
        return _all_reduce_raw(x, ctx, axes)

    @staticmethod
    def backward(fctx, g):
        return g, None, None


class _AllReduceSum(torch.autograd.Function):
    """Sum over `axes` whose backward is the sum over `axes` too: each
    rank's consumers of the sum differ (a norm's sum of squares over
    channels split across the ranks, each rank scaling its own channels),
    so each holds a partial gradient of it."""

    @staticmethod
    def forward(fctx, x, ctx, axes):
        fctx.ctx, fctx.axes = ctx, axes
        return _all_reduce_raw(x, ctx, axes)

    @staticmethod
    def backward(fctx, g):
        return _all_reduce_raw(g, fctx.ctx, fctx.axes), None, None


class _CopyTo(torch.autograd.Function):
    """The identity; the backward sums the gradient over `axes`
    (Megatron's f: each rank's consumer saw only its shard's columns)."""

    @staticmethod
    def forward(fctx, x, ctx, axes):
        fctx.ctx, fctx.axes = ctx, axes
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        return _all_reduce_raw(g, fctx.ctx, fctx.axes), None, None


class _Gather(torch.autograd.Function):
    """All-gather along `dim`. Backward ``"split"``: this rank's chunk of
    the gradient (its consumers run the same on every rank); ``"sum"``: the
    reduce-scatter of the gradient (each rank's consumers differ, as a
    rank's own q-heads reading gathered K/V)."""

    @staticmethod
    def forward(fctx, x, ctx, axes, dim, grad):
        fctx.ctx, fctx.axes, fctx.dim, fctx.grad = ctx, axes, dim, grad
        return _all_gather_raw(x, ctx, axes, dim)

    @staticmethod
    def backward(fctx, g):
        if fctx.grad == "sum":
            out = _reduce_scatter_raw(g, fctx.ctx, fctx.axes, fctx.dim)
        else:
            out = local_view(g, _spec_at(g.ndim, fctx.dim, fctx.axes),
                             fctx.ctx).contiguous()
        return out, None, None, None, None


class _Split(torch.autograd.Function):
    """This rank's chunk along `dim`; the backward all-gathers."""

    @staticmethod
    def forward(fctx, x, ctx, axes, dim):
        fctx.ctx, fctx.axes, fctx.dim = ctx, axes, dim
        return local_view(x, _spec_at(x.ndim, dim, axes), ctx).contiguous()

    @staticmethod
    def backward(fctx, g):
        return _all_gather_raw(g, fctx.ctx, fctx.axes, fctx.dim), None, \
            None, None


class _ScatterSeq(torch.autograd.Function):
    """Reduce-scatter along `dim` (the sum over `axes`, this rank's chunk
    kept), cast to `dtype`; the backward all-gathers the gradient in
    `dtype` (the sum's consumers are each rank's own chunk) and casts it
    back."""

    @staticmethod
    def forward(fctx, x, ctx, axes, dim, dtype):
        fctx.args, fctx.in_dtype = (ctx, axes, dim), x.dtype
        return _reduce_scatter_raw(x, ctx, axes, dim).to(dtype)

    @staticmethod
    def backward(fctx, g):
        ctx, axes, dim = fctx.args
        return _all_gather_raw(g, ctx, axes, dim).to(fctx.in_dtype), None, \
            None, None, None


class _AllToAll(torch.autograd.Function):

    @staticmethod
    def forward(fctx, x, ctx, axes, split_dim, concat_dim):
        fctx.args = (ctx, axes, split_dim, concat_dim)
        return _all_to_all_raw(x, ctx, axes, split_dim, concat_dim)

    @staticmethod
    def backward(fctx, g):
        ctx, axes, split_dim, concat_dim = fctx.args
        return _all_to_all_raw(g, ctx, axes, concat_dim, split_dim), None, \
            None, None, None


def _trivial(ctx, axes) -> bool:
    return ctx.axis_size(axes) == 1


def all_reduce(x, ctx: ParallelContext, axes, op: str = "sum",
               grad: str = "identity"):
    """Sum or max (no gradient) of `x` over `axes`. The sum's backward is
    the identity (``grad="identity"``: its consumers run the same on every
    rank, Megatron's g) or the sum over `axes` (``grad="sum"``: each rank
    consumes it on its own shard)."""
    if _trivial(ctx, axes):
        return x
    if op == "max":
        return _all_reduce_raw(x.detach(), ctx, axes, "max")
    if grad == "sum":
        return _AllReduceSum.apply(x, ctx, axes)
    return _AllReduce.apply(x, ctx, axes)


def copy_to(x, ctx: ParallelContext, axes):
    """Megatron's f over `axes`: identity forward, summed gradient."""
    if _trivial(ctx, axes) or not (torch.is_grad_enabled()
                                   and x.requires_grad):
        return x
    return _CopyTo.apply(x, ctx, axes)


def all_gather(x, ctx: ParallelContext, axes, dim: int, grad: str = "split"):
    if _trivial(ctx, axes):
        return x
    return _Gather.apply(x, ctx, axes, dim % x.ndim, grad)


def split(x, ctx: ParallelContext, axes, dim: int):
    if _trivial(ctx, axes):
        return x
    return _Split.apply(x, ctx, axes, dim % x.ndim)


def reduce_scatter(x, ctx: ParallelContext, axes, dim: int):
    """Sum over `axes` and keep this rank's chunk along `dim` (no
    gradient: the train step reduces gradients with it)."""
    if _trivial(ctx, axes):
        return x
    return _reduce_scatter_raw(x, ctx, axes, dim % x.ndim)


def gather_seq(x, ctx: ParallelContext, axes):
    """Sequence parallelism's entry into a layer: the ranks' slices of the
    sequence (dim 1) concatenated, in x's dtype; the backward
    reduce-scatters the gradient (each rank's consumers are its own heads
    or columns, so each holds a partial gradient). Where the residual is
    held whole, `copy_to` stands here."""
    return all_gather(x, ctx, axes, 1, grad="sum")


def scatter_seq(x, ctx: ParallelContext, axes, dtype=None):
    """Sequence parallelism's exit from a layer: partial sums (B, S, ...)
    summed over `axes` and cut to this rank's slice of the sequence (dim
    1), in one reduce-scatter, then cast to `dtype` (x's by default: the
    row-parallel products sum in float32 and round once); the backward
    all-gathers the gradient in `dtype`. Where the residual is held whole,
    `all_reduce` stands here."""
    dtype = x.dtype if dtype is None else dtype
    if _trivial(ctx, axes):
        return x.to(dtype)
    return _ScatterSeq.apply(x, ctx, axes, 1, dtype)


def all_to_all(x, ctx: ParallelContext, axes, split_dim: int,
               concat_dim: int):
    if _trivial(ctx, axes):
        return x
    return _AllToAll.apply(x, ctx, axes, split_dim % x.ndim,
                           concat_dim % x.ndim)


def gather_tree(tree, specs, ctx: ParallelContext, axes=None):
    """Each leaf whole along the dims its spec shards over `axes` (all axes
    when None): GSPMD's all-gather in front of a layer with no sharded
    form. The backward keeps this rank's chunk (the layer then runs the
    same on every rank)."""
    want = None if axes is None else set(_as_axes(axes))

    def one(x, spec):
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            ax = _as_axes(entry)
            if want is not None and not set(ax) <= want:
                continue
            x = all_gather(x, ctx, entry, dim)
        return x

    return map_trees(one, tree, specs)
