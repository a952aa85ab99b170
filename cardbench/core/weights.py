"""Random weights from the run's seed, made on the device by the benchmark
and handed to both the program and the reference.

The tree is the parameter dict the port's engine takes (``embed``,
``layers`` one dict a layer, ``final_norm``, ``unembed``), matrices stored
(in, out) in the served dtype, norm scales and the router in float32, a
norm applying ``1 + scale``. Values are drawn in a few large calls: one
bfloat16 buffer of normals for every matrix and one float32 buffer for the
rest, from a ``torch.Generator`` on the device; each leaf is a view of a
buffer, scaled in place by its fan-in.
"""
from __future__ import annotations

import math

import torch

from cardbench.core.work import Shape

CHUNK = 1 << 30          # elements a draw


def layout(s: Shape) -> list:
    """(path, shape, std, dtype) of every leaf, in tree order."""
    dt = s.dtype
    q, kv = s.hq * s.hd, s.hkv * s.hd
    out = [(("embed",), (s.vocab, s.d), 0.02, dt)]
    for i in range(s.layers):
        p = ("layers", i)
        out += [(p + ("norm1", "scale"), (s.d,), 0.1, "float32"),
                (p + ("mix", "wq"), (s.d, q), s.d ** -0.5, dt),
                (p + ("mix", "wk"), (s.d, kv), s.d ** -0.5, dt),
                (p + ("mix", "wv"), (s.d, kv), s.d ** -0.5, dt),
                (p + ("mix", "wo"), (q, s.d), q ** -0.5, dt),
                (p + ("norm2", "scale"), (s.d,), 0.1, "float32")]
        if i < s.dense_layers:
            out += _mlp(p + ("mlp",), s.d, s.ff, dt)
        else:
            m = p + ("moe",)
            e, f = s.experts, s.moe_ff
            out += [(m + ("router",), (s.d, e), 0.02, "float32"),
                    (m + ("we_gate",), (e, s.d, f), s.d ** -0.5, dt),
                    (m + ("we_up",), (e, s.d, f), s.d ** -0.5, dt),
                    (m + ("we_down",), (e, f, s.d), f ** -0.5, dt)]
            if s.shared:
                out += _mlp(m + ("shared",), s.d, s.shared * f, dt)
    out.append((("final_norm", "scale"), (s.d,), 0.1, "float32"))
    out.append((("unembed",), (s.vocab, s.d), s.d ** -0.5, dt))
    return out


def _mlp(p, d, f, dt):
    return [(p + ("w_gate",), (d, f), d ** -0.5, dt),
            (p + ("w_up",), (d, f), d ** -0.5, dt),
            (p + ("w_down",), (f, d), f ** -0.5, dt)]


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


def make_weights(s: Shape, seed: int, device) -> dict:
    """The parameter tree of `s` drawn from `seed` on `device`."""
    leaves = layout(s)
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
