"""Mixture-of-Experts layer: shared and routed experts, top-k gating.

Covers Mixtral (8 experts, top-2, gates renormalised over the top-k) and
DeepSeekMoE (fine-grained: 2 shared + 64 routed experts, top-6), as the JAX
package's ``models/moe.py`` does. Two dispatches:

* ``moe_layer`` (dense): every token goes through every expert, and the
  combine weight is zero outside its top-k. The expert products are
  batched over experts and read the (E, D, F) weights where they lie
  (``torch.matmul`` broadcasting the tokens to (E, T, D)); an einsum over
  "td,edf->tef" may copy the weights into a (D, E*F) layout on every call.
* ``moe_layer_capacity``: each row (sequence) sorts its (token, expert)
  pairs by expert, packs them into an (E, C, D) buffer with C =
  ceil(top_k * S / E * capacity_factor), and pairs past an expert's
  capacity are dropped (Switch / GShard semantics); the combine is a
  scatter-add.

The expert products are plain matrix products outside any Pallas kernel in
the JAX package too. Both return ``(out, {"moe_aux_loss": ...})``, the
Switch load-balance loss. The expert-parallel variants wait for the
distribution slice.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init, init_mlp, mlp, torch_dtype

DISPATCHES = ("dense", "capacity")


def init_moe(gen, cfg: ModelConfig, device=None):
    d = cfg.d_model
    h = cfg.moe_d_ff or cfg.d_ff
    dt = torch_dtype(cfg.dtype)
    e = cfg.n_experts
    params = {
        "router": dense_init(gen, (d, e), scale=0.02, dtype=torch.float32,
                             device=device),
        "we_gate": dense_init(gen, (e, d, h), dtype=dt, device=device),
        "we_up": dense_init(gen, (e, d, h), dtype=dt, device=device),
        "we_down": dense_init(gen, (e, h, d), dtype=dt, device=device),
    }
    if cfg.n_shared_experts:
        params["shared"] = init_mlp(gen, d, cfg.n_shared_experts * h, dt,
                                    device)
    return params


def router_probs(p, x, cfg: ModelConfig):
    """(tokens, E) routing probabilities in float32, and the top-k gates
    (renormalised to sum to one) and expert ids."""
    probs = torch.softmax(x.float() @ p["router"], dim=-1)
    topv, topi = torch.topk(probs, cfg.top_k, dim=-1)
    return probs, topv / topv.sum(dim=-1, keepdim=True), topi


def _act(cfg: ModelConfig):
    if cfg.activation == "geglu":
        return lambda g: F.gelu(g, approximate="tanh")
    return F.silu


def _experts(p, xe, cfg: ModelConfig):
    """xe: (E, T, D) or (T, D) broadcast to every expert -> (E, T, D):
    each expert's gated MLP, batched over experts."""
    gate = torch.matmul(xe, p["we_gate"])
    up = torch.matmul(xe, p["we_up"])
    return torch.matmul(_act(cfg)(gate) * up, p["we_down"])


def _aux_loss(probs, topi, e: int):
    """Switch load-balance loss: E * sum_e f_e * P_e over all tokens."""
    dispatch = F.one_hot(topi.reshape(-1, topi.shape[-1]), e).float().sum(1)
    return e * torch.sum(dispatch.mean(0) * probs.mean(0))


def moe_layer(p, x, *, cfg: ModelConfig):
    """Dense dispatch. x: (B, S, D) -> (out, {"moe_aux_loss"})."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    probs, topv, topi = router_probs(p, xt, cfg)
    # combine weights (tokens, E), zero outside the top-k, in x's dtype
    comb = torch.zeros_like(probs).scatter(1, topi, topv).to(x.dtype)
    expert_out = _experts(p, xt, cfg)                   # (E, T, D)
    out = torch.einsum("etd,te->td", expert_out, comb)
    if cfg.n_shared_experts:
        out = out + mlp(p["shared"], xt, cfg.activation)
    return out.reshape(b, s, d), {
        "moe_aux_loss": _aux_loss(probs, topi, cfg.n_experts)}


def moe_layer_capacity(p, x, *, cfg: ModelConfig,
                       capacity_factor: float = 1.25):
    """Capacity dispatch, packed per row. x: (B, S, D) -> (out,
    {"moe_aux_loss"})."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = int(math.ceil(k * s / e * capacity_factor))
    probs, topv, topi = router_probs(p, x.reshape(b * s, d), cfg)
    dev = x.device
    flat_e = topi.reshape(b, s * k)
    flat_w = topv.reshape(b, s * k)
    # the JAX package's argsort is stable; which pairs overflow depends on it
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)
    st = torch.div(order, k, rounding_mode="floor")     # token of each pair
    sw = torch.gather(flat_w, 1, order)
    start = torch.searchsorted(
        se, torch.arange(e, device=dev).expand(b, e).contiguous())
    rank = torch.arange(s * k, device=dev) - torch.gather(start, 1, se)
    keep = rank < cap
    slot = torch.where(keep, se * cap + rank, e * cap)  # overflow row e*cap
    rows = torch.arange(b, device=dev)[:, None]
    buf = x.new_zeros(b, e * cap + 1, d)
    buf[rows, slot] = x[rows, st]
    buf = buf[:, :-1].reshape(b, e, cap, d).transpose(0, 1)
    out_buf = _experts(p, buf.reshape(e, b * cap, d), cfg)   # (E, B*C, D)
    flat = out_buf.reshape(e, b, cap, d).transpose(0, 1).reshape(
        b, e * cap, d)
    contrib = flat[rows, torch.where(keep, slot, 0)] \
        * (sw * keep)[..., None].to(flat.dtype)
    out = flat.new_zeros(b, s, d).index_put_(
        (rows.expand(b, s * k), st), contrib, accumulate=True)
    if cfg.n_shared_experts:
        out = out + mlp(p["shared"], x, cfg.activation)
    return out, {"moe_aux_loss": _aux_loss(probs, topi, e)}


def moe_fn(dispatch: str):
    """The MoE layer of a dispatch name, as the JAX package picks it from
    ``ParallelContext.moe_dispatch``."""
    if dispatch not in DISPATCHES:
        raise ValueError(f"moe_dispatch {dispatch!r} not in {DISPATCHES}")
    return moe_layer_capacity if dispatch == "capacity" else moe_layer
