"""The plain reference: the configuration's decoder in float32 PyTorch, one
sequence at a time over its whole length, with no cache, no batching and no
kernel of the program. It reads the weights the benchmark made (upcast here
a layer at a time, so that it fits beside them) and the tokens the program
served, and works out everything else again.

The model: pre-norm residual blocks; RMSNorm ``x / rms(x) * (1 + scale)``;
rotary embedding on the split halves of each head, angle ``pos *
theta^(-2i/D)``; causal grouped-query attention, query head h reading
key/value head ``h // (Hq / Hkv)``; a SwiGLU MLP ``(silu(x Wg) * x Wu) Wd``;
in a mixture-of-experts layer a float32 softmax router whose top-k gates
are renormalised where ``norm_topk_prob`` says so, the routed experts' gated
sum and the shared experts' MLP; a final RMSNorm and an untied head.

``precision="fp8"`` is the control: every weight product takes its two
inputs rounded to float8 e4m3 (a scale per output channel of the weight and
per row of the activations, as an fp8 serving path would), the rest as
above.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from cardbench.core.work import Shape

Q_ROWS = 512             # query rows of one attention block
FP8_MAX = 448.0


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """`t` rounded to float8 e4m3 with one scale along each slice of
    `dim`'s complement (the scale is the slice's largest magnitude)."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = amax / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class Math:
    """The products of one precision."""

    def __init__(self, precision: str):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.fp8 = precision == "fp8"

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        """A weight (..., in, out) as this precision multiplies it."""
        w = w.float()
        return _fp8(w, -2) if self.fp8 else w

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            x = _fp8(x, -1)
        return x @ w


@contextlib.contextmanager
def exact_float32():
    """Float32 products in float32 (no TF32) on the card."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + scale.float())


def rope(x, theta: float):
    """x: (S, H, D), positions 0..S-1."""
    s, _, d = x.shape
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=x.device) / d))
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(h, w, s: Shape, theta: float, m: Math):
    n = h.shape[0]
    q = rope(m.mm(h, w["wq"]).view(n, s.hq, s.hd), theta)
    k = rope(m.mm(h, w["wk"]).view(n, s.hkv, s.hd), theta)
    v = m.mm(h, w["wv"]).view(n, s.hkv, s.hd)
    g = s.hq // s.hkv
    k = k.repeat_interleave(g, dim=1).transpose(0, 1)     # (H, S, D)
    v = v.repeat_interleave(g, dim=1).transpose(0, 1)
    q = q.transpose(0, 1) * s.hd ** -0.5
    out = torch.empty_like(q)
    for a in range(0, n, Q_ROWS):
        b = min(a + Q_ROWS, n)
        sc = q[:, a:b] @ k[:, :b].transpose(1, 2)          # (H, r, b)
        mask = torch.arange(b, device=h.device)[None, :] \
            > torch.arange(a, b, device=h.device)[:, None]
        sc = sc.masked_fill(mask, float("-inf"))
        out[:, a:b] = torch.softmax(sc, dim=-1) @ v[:, :b]
    out = out.transpose(0, 1).reshape(n, s.hq * s.hd)
    return m.mm(out, w["wo"])


def mlp(h, w, m: Math):
    return m.mm(F.silu(m.mm(h, w["w_gate"])) * m.mm(h, w["w_up"]),
                w["w_down"])


def moe(h, w, s: Shape, renorm: bool, m: Math):
    probs = torch.softmax(h @ w["router"].float(), dim=-1)
    top, idx = torch.topk(probs, s.top_k, dim=-1)
    if renorm:
        top = top / top.sum(-1, keepdim=True)
    out = mlp(h, w["shared"], m) if "shared" in w else torch.zeros_like(h)
    for e in range(s.experts):
        rows, slot = (idx == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        ew = {"w_gate": w["we_gate"][e], "w_up": w["we_up"][e],
              "w_down": w["we_down"][e]}
        y = mlp(h[rows], ew, m)
        out.index_add_(0, rows, y * top[rows, slot][:, None])
    return out


def _layer_weights(lw: dict, m: Math) -> dict:
    out = {}
    for key, val in lw.items():
        if isinstance(val, dict):
            out[key] = _layer_weights(val, m)
        elif key in ("scale", "router"):
            out[key] = val.float()
        else:
            out[key] = m.weight(val)
    return out


def logits(weights: dict, cfg: dict, seqs: list, rows: list,
           precision: str = "f32") -> list:
    """For each token sequence in `seqs` (1-D integer tensors on the
    weights' device) the float32 logits of the positions ``rows[i] =
    (start, n)``: (n, V) each. One layer's weights are upcast at a time and
    every sequence passes through it."""
    s = Shape.of(cfg)
    m = Math(precision)
    eps, theta = cfg["rms_norm_eps"], float(cfg["rope_theta"])
    renorm = bool(cfg.get("norm_topk_prob", False))
    lens = [len(t) for t in seqs]
    with exact_float32(), torch.no_grad():
        xs = [weights["embed"][t].float() for t in seqs]
        for lw_raw in weights["layers"]:
            lw = _layer_weights(lw_raw, m)
            x = torch.cat([x + attention(rmsnorm(x, lw["norm1"]["scale"],
                                                 eps), lw["mix"], s, theta, m)
                           for x in xs])
            # the MLP is token by token: all sequences at once
            h = rmsnorm(x, lw["norm2"]["scale"], eps)
            x = x + (moe(h, lw["moe"], s, renorm, m) if "moe" in lw
                     else mlp(h, lw["mlp"], m))
            xs = list(x.split(lens))
            del lw, x, h
        head = m.weight(weights["unembed"].t())
        out = []
        for x, (a, n) in zip(xs, rows, strict=True):
            h = rmsnorm(x[a:a + n], weights["final_norm"]["scale"], eps)
            out.append(m.mm(h, head))
        return out
