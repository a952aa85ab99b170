"""The Mamba-2 SSD diagonal block on the card: the wrapper of
``csrc/ssd_diag.cu``, a scores phase and an apply phase on the tensor cores.

On a CUDA tensor it launches the hand-written kernels, or raises; on a CPU
tensor it runs the plain version in ``ref.py``. ``ssd_diag.launches`` counts
the wrapper's calls that launched: one a call, though each call runs two
kernels (the chunk's C·Bᵀ tiles and cum, then the heads). Training goes
through `SSDDiagFn`, whose backward differentiates the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd_diag_ref

MAX_HEAD_DIM = 128   # P: the apply kernel's wgmma tile is at most 64 x 128


def ssd_diag(x, dt, A, Bm, Cm, *, chunk: int = 256):
    """x: (B, S, H, P); dt: (B, S, H) post-softplus; A: (H,) negative;
    Bm, Cm: (B, S, N); all float32. Returns the diagonal-block output
    (B, S, H, P) float32; ``min(chunk, S)`` must divide S."""
    if x.device.type in ("cpu", "meta"):
        return ssd_diag_ref(x, dt, A, Bm, Cm, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_diag runs on cuda or cpu, not {x.device}")
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    chunk = min(chunk, s)
    if chunk <= 0 or s % chunk:
        raise ValueError(f"chunk {chunk} must divide the sequence {s}")
    expected = {"dt": (b, s, h), "A": (h,), "Bm": (b, s, n), "Cm": (b, s, n)}
    ops = {"x": x, "dt": dt, "A": A, "Bm": Bm, "Cm": Cm}
    for name, t in ops.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, expected {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes float32")
        if name in expected and tuple(t.shape) != expected[name]:
            raise ValueError(f"{name} shape {tuple(t.shape)}, expected "
                             f"{expected[name]}")
    if p > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {p} above {MAX_HEAD_DIM}")
    x, dt, A, Bm, Cm = (t.contiguous() for t in (x, dt, A, Bm, Cm))
    out = torch.empty((b, s, h, p), dtype=torch.float32, device=x.device)
    lib = _build.load_library()
    # the chunks' score tiles and cum, written by the first kernel
    ws = torch.empty(lib.repro_ssd_workspace(b, s, h, chunk),
                     dtype=torch.float32, device=x.device)
    err = lib.repro_ssd_diag(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), out.data_ptr(), ws.data_ptr(), b, s, h, p, n, chunk,
        _build.raw_stream(x.device))
    if err != 0:
        raise RuntimeError(f"ssd_diag kernel launch failed: CUDA error {err}")
    ssd_diag.launches += 1
    return out


ssd_diag.launches = 0


class SSDDiagFn(torch.autograd.Function):
    """`ssd_diag` with a gradient: the forward is the wrapper (the kernel on
    the card, counted; the plain version on the CPU), the backward re-runs
    the plain version on the saved inputs and differentiates it, as the JAX
    package's gradient goes through its plain jnp block."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk: int):
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.chunk = chunk
        return ssd_diag(x, dt, A, Bm, Cm, chunk=chunk)

    @staticmethod
    def backward(ctx, dy):
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            y = ssd_diag_ref(*inputs, chunk=ctx.chunk)
        return (*torch.autograd.grad(y, inputs, dy), None)
