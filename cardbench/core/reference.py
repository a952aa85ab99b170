"""The plain reference: the configuration's model in float32 PyTorch, one
sequence at a time over its whole length, with no cache, no batching and no
kernel of the program. It reads the weights the benchmark made (upcast a
layer at a time, so that it fits beside them) and the tokens the program
served, and works out everything else again. The block is the
configuration's family's (``families/<model_type>.py``, its ``logits``);
here are the pieces that families share.

``precision="fp8"`` is the control (`Math`): every weight product takes its
two inputs rounded to float8 e4m3 (a scale per output channel of the weight
and per row of the activations, as an fp8 serving path would), the rest in
float32.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from cardbench.core import registry

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


def mlp(h, w, m: Math):
    return m.mm(F.silu(m.mm(h, w["w_gate"])) * m.mm(h, w["w_up"]),
                w["w_down"])


def logits(weights: dict, cfg: dict, seqs: list, rows: list,
           precision: str = "f32") -> list:
    """For each token sequence in `seqs` (1-D integer tensors on the
    weights' device) the float32 logits of the positions ``rows[i] =
    (start, n)``: (n, V) each, by the configuration's family
    (`registry.family`)."""
    return registry.family(cfg).logits(weights, cfg, seqs, rows, precision)
