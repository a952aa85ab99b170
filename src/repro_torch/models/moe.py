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
the JAX package too. Each returns ``(out, {"moe_aux_loss": ...})``, the
Switch load-balance loss.

Under a mesh (``ctx``, local shards): the dense and capacity dispatches run
on this rank's expert-hidden columns (``we_*`` split on F) and sum over the
model axis, with the load-balance statistics summed over the data axes, so
that the loss is the JAX package's over the global batch. Under sequence
parallelism (``ctx.seq_sharded``) each rank routes its own slice of the
sequence (the router's gradient summed over the model axis, the statistics
summed over it too), and the tokens, their top-k weights and ids are
gathered over the sequence before the dispatch, whose partial sums are
reduce-scattered back to the slice; where the expert-hidden columns do not
divide the model axis the layer runs on the gathered sequence, the same on
every rank (`tp.on_whole_sequence`). Two
expert-parallel forms take the expert dim over the model axis instead (the
F-split weights are re-laid by one all-to-all each, as GSPMD reshards them
for the JAX package):

* ``moe_layer_ep_a2a``: each rank routes its own tokens (its rows, and its
  slice of the sequence where the model axis divides it: under sequence
  parallelism the slice it holds, with no gather), packs them into
  an (E, C, D) buffer, exchanges it with one all-to-all so that each rank
  holds every rank's rows for its E/m experts, runs them, and returns the
  rows with the inverse all-to-all. Without a mesh it is capacity
  dispatch, and where the experts do not divide the model axis dense
  dispatch (the JAX package's own semantics). The aux loss is the mean
  over every rank.
* ``moe_layer_expert_parallel`` (the constraint form): every token through
  this rank's experts, summed over the model axis.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import block as BL
from repro_torch.models import parallel as PAR
from repro_torch.models.layers import dense_init, init_mlp, mlp, torch_dtype
from repro_torch.obs.spans import model_range

DISPATCHES = ("dense", "capacity", "ep_a2a")


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


def router_probs(p, x, cfg: ModelConfig, block=None):
    """(tokens, E) routing probabilities in float32, and the top-k gates
    (renormalised to sum to one, or by ``block``'s published rule,
    `models.block.Block.gates`) and expert ids."""
    probs = torch.softmax(x.float() @ p["router"], dim=-1)
    topv, topi = torch.topk(probs, cfg.top_k, dim=-1)
    return probs, BL.of(block).gates(topv), topi


def expert_rows(cfg: ModelConfig, dispatch: str, b: int, s: int,
                capacity_factor: float = 1.25) -> int:
    """Token-expert rows one MoE layer's dispatch computes for a (b, s)
    batch on one device: every token through every expert (dense), or
    each row's (E, C) buffer (capacity; ep_a2a without a mesh)."""
    e = cfg.n_experts
    if dispatch == "dense":
        return b * s * e
    return b * e * int(math.ceil(cfg.top_k * s / e * capacity_factor))


def _act(cfg: ModelConfig):
    if cfg.activation == "geglu":
        return lambda g: F.gelu(g, approximate="tanh")
    return F.silu


def _experts(p, xe, cfg: ModelConfig, wide: bool = False):
    """xe: (E, T, D) or (T, D) broadcast to every expert -> (E, T, D):
    each expert's gated MLP, batched over experts. ``wide``: the last
    product in float32 (a partial sum over the model axis, `tp.wide`)."""
    gate = torch.matmul(xe, p["we_gate"])
    up = torch.matmul(xe, p["we_up"])
    h = _act(cfg)(gate) * up
    if wide:
        return torch.matmul(h.float(), p["we_down"].float())
    return torch.matmul(h, p["we_down"])


def _aux_loss(probs, topi, e: int, ctx=None):
    """Switch load-balance loss: E * sum_e f_e * P_e over all tokens. Under
    a mesh the sums run over the data axes, so that the loss is the global
    batch's (where the rows are not split, every data rank adds the same
    rows, and the fractions are unchanged), and under sequence parallelism
    over the model axis too (each rank routed its slice)."""
    dispatch = F.one_hot(topi.reshape(-1, topi.shape[-1]), e).float().sum(1)
    axes = ()
    if PAR.is_sharded(ctx):
        if ctx.batch_size_divisor > 1:
            axes = PAR._as_axes(ctx.batch_spec)
        if ctx.seq_sharded:
            axes += (ctx.model_axis,)
    if not axes:
        return e * torch.sum(dispatch.mean(0) * probs.mean(0))
    stats = torch.cat([dispatch.sum(0), probs.sum(0),
                       probs.new_full((1,), probs.shape[0])])
    stats = PAR.all_reduce(stats, ctx, axes)
    n = stats[-1]
    return e * torch.sum((stats[:e] / n) * (stats[e:2 * e] / n))


def _f_split(cfg: ModelConfig, ctx) -> bool:
    return PAR.is_sharded(ctx) and ctx.model_spec_if(
        cfg.moe_d_ff or cfg.d_ff) is not None


def _shared_partial(p, x, cfg: ModelConfig, ctx):
    """The shared experts' MLP: (out, whether a partial sum over model)."""
    if not PAR.is_sharded(ctx):
        return mlp(p["shared"], x, cfg.activation), False
    from repro_torch.models import tp as TP
    return TP.mlp_partial(p["shared"], x, cfg.activation, ctx,
                          _shared_hidden(cfg))


def _shared_hidden(cfg: ModelConfig) -> int:
    return cfg.n_shared_experts * (cfg.moe_d_ff or cfg.d_ff)


def _finish(out, p, x, cfg: ModelConfig, ctx, x_in=None):
    """Add the shared experts and sum the partial sums over model (kept
    in float32 where the model is narrower, `tp.wide`), at x's layout in
    x's dtype. ``x_in``: x as it entered this rank's expert columns
    (`tp.enter`), given where `out` is a partial sum over model (at its
    layout); the shared experts reuse it where their columns are split
    too."""
    from repro_torch.models import tp as TP
    dt = x.dtype
    partial = x_in is not None
    if not cfg.n_shared_experts:
        return TP.sum_partials(out, ctx, dt) if partial else out
    if partial and TP._sharded_dim(ctx, _shared_hidden(cfg)):
        sh = TP.mlp_columns(p["shared"], x_in, cfg.activation)
        return TP.sum_partials(out + sh, ctx, dt)
    sh, sh_partial = _shared_partial(p, x, cfg, ctx)
    if partial:
        out = TP.sum_partials(out, ctx, dt)
    return out + (TP.sum_partials(sh, ctx, dt) if sh_partial else sh)


def _route(p, x, cfg: ModelConfig, ctx, partial: bool, block=None):
    """Route x (B, S, D): (the tokens as the experts take them (B, S', D),
    the top-k gates (B, S', k) float32 and ids (B, S', k), the aux loss).
    Where ``partial`` (this rank's expert columns: a partial sum over
    model) the tokens and gates enter through `tp.enter`; under sequence
    parallelism each rank routes its own slice and S' is the gathered
    sequence (gates and ids in one all-gather, the ids as exact floats)."""
    from repro_torch.models import tp as TP
    b, s, d = x.shape
    k = cfg.top_k
    router = p["router"]
    if PAR.is_sharded(ctx):
        router, = TP.seq_leaves(ctx, router)
    probs, topv, topi = router_probs({"router": router}, x.reshape(b * s, d),
                                     cfg, block)
    aux = _aux_loss(probs, topi, cfg.n_experts, ctx)
    topv, topi = topv.view(b, s, k), topi.view(b, s, k)
    if not partial:
        return x, topv, topi, aux
    if ctx.seq_sharded:
        both = TP.enter(torch.cat([topv, topi.to(topv.dtype)], -1), ctx)
        return TP.enter(x, ctx), both[..., :k], both[..., k:].long(), aux
    return TP.enter(x, ctx), TP.enter(topv, ctx), topi, aux


def _seq_whole(cfg: ModelConfig, ctx) -> bool:
    """Whether the dense and capacity dispatches run on the gathered
    sequence: sequence parallelism without split expert columns."""
    return PAR.is_sharded(ctx) and ctx.seq_sharded and not _f_split(cfg,
                                                                    ctx)


def moe_layer(p, x, *, cfg: ModelConfig, ctx=None, block=None):
    """Dense dispatch. x: (B, S, D) -> (out, {"moe_aux_loss"}). Ranges:
    ``model.moe.route``, ``model.moe.experts``, ``model.moe.shared``."""
    if _seq_whole(cfg, ctx):
        from repro_torch.models import tp as TP
        return TP.on_whole_sequence(
            lambda xw, c: moe_layer(p, xw, cfg=cfg, ctx=c, block=block), x,
            ctx)
    partial = _f_split(cfg, ctx)
    with model_range("model.moe.route"):
        xin, topv, topi, aux = _route(p, x, cfg, ctx, partial, block)
        b, s, d = xin.shape
        k, e = cfg.top_k, cfg.n_experts
        # combine weights (tokens, E), zero outside the top-k, in x's dtype
        comb = topv.new_zeros(b * s, e).scatter(
            1, topi.reshape(b * s, k), topv.reshape(b * s, k)).to(x.dtype)
        if partial:      # this rank's F columns: a partial sum over model
            comb = comb.float()
    with model_range("model.moe.experts"):
        expert_out = _experts(p, xin.reshape(b * s, d), cfg,
                              wide=partial)                  # (E, T, D)
        out = torch.einsum("etd,te->td", expert_out, comb).reshape(b, s, d)
    with model_range("model.moe.shared"):
        out = _finish(out, p, x, cfg, ctx, xin if partial else None)
    return out, {"moe_aux_loss": aux}


def moe_layer_capacity(p, x, *, cfg: ModelConfig,
                       capacity_factor: float = 1.25, ctx=None, block=None):
    """Capacity dispatch, packed per row. x: (B, S, D) -> (out,
    {"moe_aux_loss"})."""
    if _seq_whole(cfg, ctx):
        from repro_torch.models import tp as TP
        return TP.on_whole_sequence(
            lambda xw, c: moe_layer_capacity(
                p, xw, cfg=cfg, capacity_factor=capacity_factor, ctx=c,
                block=block),
            x, ctx)
    partial = _f_split(cfg, ctx)
    x_res = x
    x, topv, topi, aux = _route(p, x, cfg, ctx, partial, block)
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = int(math.ceil(k * s / e * capacity_factor))
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
    out_buf = _experts(p, buf.reshape(e, b * cap, d), cfg,
                       wide=partial)                          # (E, B*C, D)
    flat = out_buf.reshape(e, b, cap, d).transpose(0, 1).reshape(
        b, e * cap, d)
    contrib = flat[rows, torch.where(keep, slot, 0)] \
        * (sw * keep)[..., None].to(flat.dtype)
    out = flat.new_zeros(b, s, d).index_put_(
        (rows.expand(b, s * k), st), contrib, accumulate=True)
    out = _finish(out, p, x_res, cfg, ctx, x if partial else None)
    return out, {"moe_aux_loss": aux}


def _local_experts(p, cfg: ModelConfig, ctx):
    """we_gate, we_up, we_down of this rank's E/m experts, F whole."""
    f_split = _f_split(cfg, ctx)
    ma = ctx.model_axis

    def ep(w, f_dim):
        if f_split:
            return PAR.all_to_all(w, ctx, ma, split_dim=0, concat_dim=f_dim)
        return PAR.split(w, ctx, ma, 0)

    return {"we_gate": ep(p["we_gate"], 2), "we_up": ep(p["we_up"], 2),
            "we_down": ep(p["we_down"], 1)}


def moe_layer_ep_a2a(p, x, *, cfg: ModelConfig, ctx=None,
                     capacity_factor: float = 1.25, block=None):
    """Expert-parallel MoE with explicit all-to-alls (see the module
    docstring). x: this rank's (B, S, D) rows -> (out, {"moe_aux_loss"})."""
    e, k = cfg.n_experts, cfg.top_k
    m = ctx.model_size if PAR.is_sharded(ctx) else 1
    if not PAR.is_sharded(ctx) or m == 1 or e % m:
        # the JAX package's semantics: dense dispatch on a mesh whose model
        # axis the experts do not divide, capacity dispatch without one
        if PAR.is_sharded(ctx) and m > 1:
            return moe_layer(p, x, cfg=cfg, ctx=ctx, block=block)
        return moe_layer_capacity(p, x, cfg=cfg,
                                  capacity_factor=capacity_factor,
                                  block=block)
    b, s, d = x.shape
    ma = ctx.model_axis
    # under sequence parallelism x is this rank's slice already
    seq_split = not ctx.seq_sharded and s % m == 0
    if not (seq_split or ctx.seq_sharded) and torch.is_grad_enabled() \
            and x.requires_grad:
        raise NotImplementedError(
            "ep_a2a's backward needs the sequence to split over the model "
            "axis (each rank routing its own tokens)")
    s_loc = s // m if seq_split else s
    cap = int(math.ceil(k * b * s_loc / e * capacity_factor))
    xl = PAR.split(x, ctx, ma, 1) if seq_split else x
    router = PAR.copy_to(p["router"], ctx, ma) \
        if seq_split or ctx.seq_sharded else p["router"]
    w = _local_experts(p, cfg, ctx)

    tl = b * s_loc
    xt = xl.reshape(tl, d)
    probs = torch.softmax(xt.float() @ router, dim=-1)
    topv, topi = torch.topk(probs, k, dim=-1)
    topv = BL.of(block).gates(topv).to(x.dtype)
    flat_e = topi.reshape(tl * k)
    flat_w = topv.reshape(tl * k)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    st = torch.div(order, k, rounding_mode="floor")
    sw = flat_w[order]
    start = torch.searchsorted(se, torch.arange(e, device=x.device))
    rank = torch.arange(tl * k, device=x.device) - start[se]
    keep = rank < cap
    slot = torch.where(keep, se * cap + rank, e * cap)
    buf = xt.new_zeros(e * cap + 1, d).index_copy(0, slot, xt[st])
    buf = buf[:-1].reshape(e, cap, d)
    # exchange: (E, C, D) -> (E/m, m*C, D), every rank's rows for mine
    buf = PAR.all_to_all(buf, ctx, ma, split_dim=0, concat_dim=1)
    out_buf = _experts(w, buf, cfg)
    # inverse exchange: the rows return to their source rank
    out_buf = PAR.all_to_all(out_buf, ctx, ma, split_dim=1, concat_dim=0)
    # each token's k rows summed in float32, as dense dispatch's einsum
    # sums its experts
    flat = out_buf.reshape(e * cap, d).float()
    contrib = flat[torch.where(keep, slot, 0)] \
        * (sw * keep).float()[:, None]
    out = flat.new_zeros(tl, d).index_add(0, st, contrib).to(x.dtype)
    out = out.reshape(b, s_loc, d)
    if seq_split:
        out = PAR.all_gather(out, ctx, ma, 1)

    disp = F.one_hot(topi, e).float().sum(1)
    aux = e * torch.sum(disp.mean(0) * probs.mean(0))
    aux = PAR.all_reduce(aux, ctx, ctx.mesh.axis_names) / ctx.mesh.size
    out = _finish(out, p, x, cfg, ctx)
    return out, {"moe_aux_loss": aux}


def moe_layer_expert_parallel(p, x, *, cfg: ModelConfig, ctx=None,
                              block=None):
    """The constraint form: the expert dim over the model axis where it
    divides, every token through this rank's experts, summed over model;
    else `moe_layer`. The math is `moe_layer`'s."""
    e = cfg.n_experts
    if not PAR.is_sharded(ctx) or ctx.model_size == 1 \
            or e % ctx.model_size:
        return moe_layer(p, x, cfg=cfg, ctx=ctx, block=block)
    xin, topv, topi, aux = _route(p, x, cfg, ctx, True, block)
    b, s, d = xin.shape
    k = cfg.top_k
    comb = topv.new_zeros(b * s, e).scatter(
        1, topi.reshape(b * s, k), topv.reshape(b * s, k)).to(x.dtype)
    el = e // ctx.model_size
    r = ctx.axis_index(ctx.model_axis)
    comb = comb[:, r * el:(r + 1) * el]
    w = _local_experts(p, cfg, ctx)
    expert_out = _experts(w, xin.reshape(b * s, d), cfg)   # (E/m, T, D)
    # this rank's experts: a partial sum over model, in float32
    out = torch.einsum("etd,te->td", expert_out.float(), comb.float())
    out = _finish(out.reshape(b, s, d), p, x, cfg, ctx, xin)
    return out, {"moe_aux_loss": aux}


def moe_fn(dispatch: str, ctx=None):
    """The MoE layer of a dispatch name, as the JAX package picks it from
    ``ParallelContext.moe_dispatch`` (and ``moe_expert_parallel``, which
    takes the constraint form where the dispatch is dense)."""
    if dispatch not in DISPATCHES:
        raise ValueError(f"moe_dispatch {dispatch!r} not in {DISPATCHES}")
    if dispatch == "capacity":
        return moe_layer_capacity
    if dispatch == "ep_a2a":
        return moe_layer_ep_a2a
    if ctx is not None and ctx.moe_expert_parallel:
        return moe_layer_expert_parallel
    return moe_layer
