"""RG-LRU recurrent block (RecurrentGemma / Griffin).

The temporal-mixing block is two parallel projections of the input: a GeLU
gate branch and a recurrence branch (a causal conv, then the RG-LRU gated
linear recurrence), multiplied and projected back.

    r_t = sigmoid(w_a * u_t + b_a)            (recurrence gate)
    i_t = sigmoid(w_x * u_t + b_x)            (input gate)
    log a_t = -c * softplus(lam) * r_t        (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

The gates are diagonal (per channel), as in the JAX package. Train and
prefill evaluate the recurrence over S with a log-depth doubling scan of
the pairs (a, b) -> (a * a', a' * b + b'), ceil(log2 S) steps of a few
elementwise ops on (B, S, d_rnn); decode is the O(1) step. The gates, the
scan and the state are float32 (``w_a``, ``b_a``, ``w_x``, ``b_x`` and
``lam`` are float32 leaves in a bf16 model, as in JAX). Plain PyTorch: the
JAX package has no Pallas kernel here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init, torch_dtype

_C = 8.0


def _d_rnn(cfg: ModelConfig) -> int:
    return cfg.rglru.d_rnn or cfg.d_model


def init_rglru(gen, cfg: ModelConfig, device=None):
    d = cfg.d_model
    dr = _d_rnn(cfg)
    dt = torch_dtype(cfg.dtype)
    f32 = dict(dtype=torch.float32, device=device)
    # lam such that a is in [0.9, 0.999] at r = 1 (Griffin appendix)
    a0 = 0.9 + (0.999 - 0.9) * torch.rand((dr,), generator=gen, **f32)
    return {
        "w_gate_in": dense_init(gen, (d, dr), dtype=dt, device=device),
        "w_rec_in": dense_init(gen, (d, dr), dtype=dt, device=device),
        "conv": dense_init(gen, (cfg.rglru.d_conv, dr), scale=0.2, dtype=dt,
                           device=device),
        "w_a": torch.zeros((dr,), **f32),
        "b_a": torch.zeros((dr,), **f32),
        "w_x": torch.zeros((dr,), **f32),
        "b_x": torch.zeros((dr,), **f32),
        "lam": torch.log(torch.expm1(-torch.log(a0) / _C)),
        "out_proj": dense_init(gen, (dr, d), dtype=dt, device=device),
    }


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype=None, device=None):
    """{"h": (B, d_rnn) float32, "conv": (B, d_conv - 1, d_rnn)}: no
    sequence axis, so a paged cache snapshots both whole."""
    dr = _d_rnn(cfg)
    dt = dtype or torch_dtype(cfg.dtype)
    return {
        "h": torch.zeros((batch, dr), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.rglru.d_conv - 1, dr), dtype=dt,
                            device=device),
    }


def _gates(p, u):
    """(a, gated input) in float32 for the inputs u (..., d_rnn)."""
    uf = u.float()
    r = torch.sigmoid(p["w_a"] * uf + p["b_a"])
    i = torch.sigmoid(p["w_x"] * uf + p["b_x"])
    log_a = -_C * F.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    gated_in = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9)) \
        * (i * uf)
    return a, gated_in


def _conv_causal(u, kernel, state=None):
    """Depthwise causal conv along S (no activation). u: (B, S, C); kernel:
    (K, C). Returns (conv, the last K - 1 rows of the padded input)."""
    k = kernel.shape[0]
    pad = (torch.zeros((u.shape[0], k - 1, u.shape[2]), dtype=u.dtype,
                       device=u.device)
           if state is None else state.to(u.dtype))
    up = torch.cat([pad, u], dim=1)
    out = sum(up[:, i:i + u.shape[1]] * kernel[i] for i in range(k))
    return out, (up[:, -(k - 1):] if k > 1 else None)


def linear_scan(a, b):
    """h_t = a_t * h_{t-1} + b_t along axis 1 from h_{-1} = 0, for (B, S,
    C) tensors: the inclusive scan of the pairs (a, b) under (a1, b1) o (a2,
    b2) = (a1 * a2, a2 * b1 + b2), by doubling (ceil(log2 S) steps, each
    combining every position with the one `off` before it)."""
    s = a.shape[1]
    off = 1
    while off < s:
        b = torch.cat([b[:, :off],
                       torch.addcmul(b[:, off:], a[:, off:], b[:, :-off])],
                      dim=1)
        if 2 * off < s:
            a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return b


def rglru_layer(p, x, *, cfg: ModelConfig, mode: str, cache=None):
    """The Griffin recurrent mixing layer (no residual). Returns (out,
    cache'); the cache's tensors are updated in place for prefill and
    decode."""
    gate = F.gelu(x @ p["w_gate_in"], approximate="tanh")
    y, new_cache = recurrence(p, x @ p["w_rec_in"], mode=mode, cache=cache)
    y = (gate.float() * y).to(x.dtype)
    return y @ p["out_proj"], new_cache


def recurrence(p, u, *, mode: str, cache=None):
    """The recurrence branch after its input projection: the causal conv
    and the RG-LRU over the channels of ``u`` (B, S, C), with ``p``'s conv
    kernel and gate vectors for those channels. Returns (y (B, S, C)
    float32, cache'), the cache updated in place for prefill and decode.
    Every op is per channel, so a rank of a mesh runs it on its own
    channels alone."""
    if mode == "decode":
        if u.shape[1] != 1:
            raise ValueError(f"decode takes one token per row, got "
                             f"{u.shape[1]}")
        u, conv_state = _conv_causal(u, p["conv"], cache["conv"])
        a, gi = _gates(p, u[:, 0])
        h = a * cache["h"] + gi
        y = h[:, None, :]
        cache["h"].copy_(h)
        cache["conv"].copy_(conv_state)
        new_cache = cache
    else:
        u, conv_state = _conv_causal(u, p["conv"])
        a, gi = _gates(p, u)                      # (B, S, dr) each
        y = linear_scan(a, gi)
        new_cache = None
        if mode == "prefill" and cache is not None:
            # the state after the last row, bucket padding included (as in
            # the JAX package)
            cache["h"].copy_(y[:, -1])
            cache["conv"].copy_(conv_state)
            new_cache = cache
    return y, new_cache
