"""Operation-counting FLOP/byte cost model.

The port's counterpart of the JAX package's jaxpr walker: the step runs
once under a ``TorchDispatchMode`` (on meta tensors, so nothing is
computed or allocated) and every ATen operation it dispatches is counted,
with the walker's rules:

  flops — 2·M·N·K for a matrix product (mm, bmm, addmm, baddbmm; an einsum
          or matmul arrives as one of them) and 2·(output elements)·(kernel
          elements per output) for a convolution; every other operation
          one FLOP an output element, except the data movements (views,
          copies, casts, indexing, concatenation, factories), which count
          none.
  bytes — operand plus result bytes of every operation but a view,
          unfused (an upper bound on the memory traffic).

A Python loop counts each trip, as the walker multiplies a ``scan`` body
by its length, and a backward pass counts because autograd dispatches its
operations under the mode (a recomputation under ``torch.utils.checkpoint``
counts again). ``product_flops`` is the products' share, which the tests
hold against the walker's ``dot_general`` FLOPs.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

aten = torch.ops.aten

_PRODUCTS = {aten.mm.default, aten.bmm.default, aten.addmm.default,
             aten.baddbmm.default}
_VIEWS = {
    "view", "_unsafe_view", "reshape", "expand", "permute", "transpose",
    "t", "slice", "select", "unsqueeze", "squeeze", "as_strided", "alias",
    "detach", "split", "split_with_sizes", "unbind", "chunk", "narrow",
    "view_as_real", "view_as_complex", "movedim", "lift_fresh", "unfold",
    "_reshape_alias", "diagonal", "expand_as", "view_as",
}
_MOVES = {
    "_to_copy", "copy", "copy_", "clone", "contiguous", "cat", "stack",
    "index", "index_select", "gather", "scatter", "index_put",
    "index_put_", "embedding", "zeros", "zeros_like", "empty",
    "empty_like", "empty_strided", "full", "full_like", "arange", "ones",
    "ones_like", "new_zeros", "new_empty", "new_full", "new_ones", "fill",
    "fill_", "zero_", "repeat", "constant_pad_nd", "pad", "flip", "roll",
    "masked_fill", "where", "index_copy", "scalar_tensor", "_index_put_impl_",
    "select_scatter", "slice_scatter", "index_add", "scatter_add",
    "tril", "triu", "one_hot", "repeat_interleave", "_local_scalar_dense",
    "randint", "randn", "rand", "normal", "lift", "resize_",
}


def _bytes(x) -> float:
    if isinstance(x, torch.Tensor):
        return float(x.numel() * x.element_size())
    return 0.0


def _numel(x) -> float:
    return float(x.numel()) if isinstance(x, torch.Tensor) else 0.0


def _product_flops(func, args, out) -> float:
    if func in (aten.mm.default, aten.addmm.default):
        a, b = (args[0], args[1]) if func == aten.mm.default \
            else (args[1], args[2])
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
    a, b = (args[0], args[1]) if func == aten.bmm.default \
        else (args[1], args[2])
    return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]


class CostMode(TorchDispatchMode):
    """Counts FLOPs and bytes of every operation dispatched under it."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.product_flops = 0.0
        self.bytes = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        base = func.overloadpacket.__name__
        stem = base.rstrip("_")
        if base in _VIEWS or stem in _VIEWS:
            return out
        ins = [x for x in tree_flatten((args, kwargs))[0]
               if isinstance(x, torch.Tensor)]
        outs = [x for x in tree_flatten(out)[0]
                if isinstance(x, torch.Tensor)]
        self.bytes += sum(map(_bytes, ins)) + sum(map(_bytes, outs))
        if func in _PRODUCTS:
            f = _product_flops(func, args, out)
            self.product_flops += f
            self.flops += f
            if func in (aten.addmm.default, aten.baddbmm.default):
                self.flops += _numel(out)
        elif stem == "convolution":
            w = args[1]
            per = 2.0 * math.prod(w.shape[1:])
            f = per * _numel(outs[0])
            self.product_flops += f
            self.flops += f
        elif base not in _MOVES and stem not in _MOVES:
            self.flops += sum(map(_numel, outs))
        return out


def step_cost(fn, *args) -> Dict[str, float]:
    """Global (unpartitioned) cost of ``fn(*args)``: {"flops", "bytes",
    "product_flops"}. Pass meta tensors (or trees of them) to count a
    full-size step without computing it."""
    mode = CostMode()
    with mode:
        fn(*args)
    return {"flops": mode.flops, "bytes": mode.bytes,
            "product_flops": mode.product_flops}
