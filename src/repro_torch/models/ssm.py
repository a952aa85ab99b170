"""Mamba-2 block with the SSD (state-space duality) chunked algorithm.

Prefill runs the chunked SSD form: within a chunk, the quadratic diagonal
block; across chunks, a linear recurrence over the (B, H, P, N) state,
here a Python loop over chunks carrying the float32 state (the JAX
package's `lax.scan`). The diagonal block of the whole padded sequence
comes from one `ssd_diag` call after the loop: the CUDA kernel on the card,
its plain version on the CPU. Decode is the dual recurrent form: an O(1)
float32 state update per token. The causal conv is a 4-tap shifted sum,
plain PyTorch.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import (
    dense_init, init_rmsnorm, rmsnorm, torch_dtype,
)


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    return s, s.d_inner(cfg.d_model), s.n_heads(cfg.d_model)


def _uniform(gen, shape, lo: float, hi: float, device=None):
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    return lo + (hi - lo) * u


def init_ssm(gen, cfg: ModelConfig, device=None):
    s, di, nh = _dims(cfg)
    d = cfg.d_model
    dt = torch_dtype(cfg.dtype)
    conv_dim = di + 2 * s.d_state
    # dt_bias is softplus^-1 of a log-uniform step in [0.001, 0.1]
    log_step = _uniform(gen, (nh,), math.log(0.001), math.log(0.1), device)
    return {
        "wz": dense_init(gen, (d, di), dtype=dt, device=device),
        "wx": dense_init(gen, (d, di), dtype=dt, device=device),
        "wB": dense_init(gen, (d, s.d_state), dtype=dt, device=device),
        "wC": dense_init(gen, (d, s.d_state), dtype=dt, device=device),
        "w_dt": dense_init(gen, (d, nh), dtype=dt, device=device),
        "dt_bias": torch.log(torch.expm1(torch.exp(log_step))),
        "A_log": torch.log(_uniform(gen, (nh,), 1.0, 16.0, device)),
        "D": torch.ones((nh,), dtype=torch.float32, device=device),
        "conv": dense_init(gen, (s.d_conv, conv_dim), scale=0.2, dtype=dt,
                           device=device),
        "norm": init_rmsnorm(di, device),
        "out_proj": dense_init(gen, (di, d), dtype=dt, device=device),
    }


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype=None, device=None):
    """{"state": (B, H, P, N) float32, "conv": (B, d_conv - 1, conv_dim)}:
    no sequence axis, so a paged cache snapshots both whole."""
    s, di, nh = _dims(cfg)
    dt = dtype or torch_dtype(cfg.dtype)
    conv_dim = di + 2 * s.d_state
    return {
        "state": torch.zeros((batch, nh, s.head_dim, s.d_state),
                             dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, s.d_conv - 1, conv_dim), dtype=dt,
                            device=device),
    }


def _causal_conv(u, kernel, conv_state=None):
    """Depthwise causal conv along S. u: (B, S, C); kernel: (K, C).
    Returns (silu(conv), the last K - 1 inputs)."""
    k = kernel.shape[0]
    pad = (torch.zeros((u.shape[0], k - 1, u.shape[2]), dtype=u.dtype,
                       device=u.device)
           if conv_state is None else conv_state.to(u.dtype))
    up = torch.cat([pad, u], dim=1)
    out = sum(up[:, i:i + u.shape[1]] * kernel[i] for i in range(k))
    new_state = up[:, -(k - 1):] if k > 1 else None
    return F.silu(out), new_state


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int):
    """SSD forward, chunk-parallel (Mamba-2 Alg. 1 dual form).

    x: (B, S, H, P); dt: (B, S, H) (post-softplus); A: (H,) negative;
    Bm, Cm: (B, S, N), one group broadcast across heads. Returns y
    (B, S, H, P) in x.dtype and the final state (B, H, P, N) float32.
    The loop carries the state across chunks; the diagonal block of the
    whole padded sequence comes from one `ssd_diag` call after it, which
    runs the CUDA kernel on the card and its plain version on the CPU.
    """
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    s_orig = s
    if s % chunk:
        # zero-pad the tail: dt = 0 there, so decay = 1 and the state is
        # untouched
        pad = chunk - s % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
        s = s + pad
    nc = s // chunk
    f32 = torch.float32
    xr = x.reshape(b, nc, chunk, h, p).to(f32)
    dtr = dt.reshape(b, nc, chunk, h).to(f32)
    Br = Bm.reshape(b, nc, chunk, n).to(f32)
    Cr = Cm.reshape(b, nc, chunk, n).to(f32)

    state = torch.zeros((b, h, p, n), dtype=f32, device=x.device)
    ys = []
    for c in range(nc):
        xc, dtc, Bc, Cc = xr[:, c], dtr[:, c], Br[:, c], Cr[:, c]
        cum = torch.cumsum(dtc * A, dim=1)                  # (B, Q, H)
        dtx = dtc[..., None] * xc                           # (B, Q, H, P)
        # contribution of the state carried in from earlier chunks
        y = torch.einsum("bqn,bhpn->bqhp", Cc, state) \
            * torch.exp(cum)[..., None]
        decay_to_end = torch.exp(cum[:, -1:, :] - cum)      # (B, Q, H)
        state_c = torch.einsum("bqn,bqh,bqhp->bhpn", Bc, decay_to_end, dtx)
        state = state * torch.exp(cum[:, -1])[:, :, None, None] + state_c
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(b, s, h, p)
    y = y + kops.ssd_diag(x.to(f32), dt.to(f32), A, Bm.to(f32), Cm.to(f32),
                          chunk=chunk)
    y = y[:, :s_orig]
    return y.to(x.dtype), state


def ssm_layer(p, x, *, cfg: ModelConfig, mode: str, cache=None):
    """The Mamba-2 mixing layer (no residual). Returns (out, cache'); the
    cache's tensors are updated in place for prefill and decode."""
    s_cfg, di, nh = _dims(cfg)
    s = x.shape[1]
    d_conv = s_cfg.d_conv

    z = x @ p["wz"]
    xin = x @ p["wx"]
    Bm = x @ p["wB"]
    Cm = x @ p["wC"]
    dt = F.softplus((x @ p["w_dt"]).float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    conv_in = torch.cat([xin, Bm, Cm], dim=-1)

    new_cache = None
    if mode == "decode":
        conv_out, conv_state = _causal_conv(conv_in, p["conv"], cache["conv"])
        y, state = ssd_mix(conv_out, dt, A, p["D"], s_cfg=s_cfg, mode=mode,
                           state=cache["state"], dtype=x.dtype)
        cache["state"].copy_(state)
        cache["conv"].copy_(conv_state)
        new_cache = cache
    else:
        conv_out, _ = _causal_conv(conv_in, p["conv"])
        y, final_state = ssd_mix(conv_out, dt, A, p["D"], s_cfg=s_cfg,
                                 mode=mode, dtype=x.dtype)
        if mode == "prefill" and cache is not None:
            # the conv state is the prompt's last d_conv - 1 inputs (bucket
            # padding included, as in the JAX package)
            keep = min(d_conv - 1, s)
            cache["state"].copy_(final_state)
            cache["conv"].zero_()
            cache["conv"][:, d_conv - 1 - keep:] = conv_in[:, s - keep:]
            new_cache = cache

    y = rmsnorm(p["norm"], y * F.silu(z)).to(x.dtype)
    return y @ p["out_proj"], new_cache


def ssd_mix(conv_out, dt, A, D, *, s_cfg, mode: str, state=None, dtype):
    """The SSD over the conv's output ``[x | B | C]`` (B, S, H*P + 2N),
    for the H heads of ``dt`` (B, S, H), ``A`` and ``D`` (H,): decode steps
    ``state`` (B, H, P, N) float32 by one token, train and prefill run
    `ssd_chunked`. Returns (y (B, S, H*P), the new or final state). The
    heads are independent (B and C are one group shared by all), so a rank
    of a mesh runs it on its own heads alone."""
    b, s, _ = conv_out.shape
    n, hd = s_cfg.d_state, s_cfg.head_dim
    nh = dt.shape[-1]
    xin, Bm, Cm = torch.split(conv_out, [nh * hd, n, n], dim=-1)
    if mode == "decode":
        if s != 1:
            raise ValueError(f"decode takes one token per row, got {s}")
        xh = xin.reshape(b, nh, hd).float()
        dt1 = dt[:, 0]                                      # (B, H)
        da = torch.exp(dt1 * A)
        upd = torch.einsum("bh,bhp,bn->bhpn", dt1, xh, Bm[:, 0].float())
        state = state * da[:, :, None, None] + upd
        y = torch.einsum("bn,bhpn->bhp", Cm[:, 0].float(), state)
        y = y + D[:, None] * xh
        return y.reshape(b, 1, nh * hd).to(dtype), state
    xh = xin.reshape(b, s, nh, hd)
    y, final_state = ssd_chunked(xh, dt, A, Bm, Cm,
                                 min(s_cfg.chunk_size, s))
    y = y + D[None, None, :, None] * xh.to(y.dtype)
    return y.reshape(b, s, nh * hd), final_state
