"""Random weights from the run's seed, made on the device by the benchmark
and handed to both the program and the reference.

The tree is the parameter dict the port's engine takes, with the leaves
the configuration's family lists (its shape's ``layout()``,
``families/__init__.py``). Values are drawn in a few large calls: one
buffer of normals a dtype (the served dtype's for the matrices, float32
for the rest), from a ``torch.Generator`` on the device, in the order the
leaves are listed; each leaf is a view of a buffer, scaled in place by its
std.
"""
from __future__ import annotations

import math

import torch

CHUNK = 1 << 30          # elements a draw


def _set(tree, path, value):
    node = tree
    for key, nxt in zip(path[:-1], path[1:], strict=True):
        if isinstance(key, int):
            while len(node) <= key:
                node.append({})
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    node[path[-1]] = value


def _normals(n: int, dtype, gen, device) -> torch.Tensor:
    buf = torch.empty(n, dtype=dtype, device=device)
    for a in range(0, n, CHUNK):
        buf[a:a + CHUNK].normal_(generator=gen)
    return buf


def make_weights(s, seed: int, device) -> dict:
    """The parameter tree of the shape `s` drawn from `seed` on `device`."""
    leaves = s.layout()
    gen = torch.Generator(device=device).manual_seed(seed)
    bufs, used = {}, {}
    for dt in sorted({leaf[3] for leaf in leaves}):
        n = sum(math.prod(shape) for _, shape, _, d in leaves if d == dt)
        bufs[dt] = _normals(n, getattr(torch, dt), gen, device)
        used[dt] = 0
    tree = {}
    for path, shape, std, dt in leaves:
        n, a = math.prod(shape), used[dt]
        view = bufs[dt][a:a + n].view(shape)
        view.mul_(std)
        used[dt] = a + n
        _set(tree, path, view)
    return tree
