"""The model's layers on local shards: tensor, context and expert
parallelism in the Megatron form.

Each function here takes this rank's shards (parameters by
`parallel.param_specs`, caches by `launch.shardings.cache_specs_tree`,
batches by the data axes) and issues the collectives that GSPMD inserts
for the JAX package, through the counted helpers of `models/parallel.py`:

* attention: the column-parallel ``wq``/``wk``/``wv`` give this rank's
  q-heads when the heads divide the model axis (else all of them, gathered);
  K/V are gathered when their columns split a head (gemma-2b's one kv-head
  of 256 columns); the flash and decode kernels run on the rank's heads;
  the row-parallel ``wo`` ends in an all-reduce.
* context-parallel decode (`cp_decode`): where the cache's sequence is
  split over an axis, the owning shard writes the new row, every shard
  runs the decode kernel over its slice with the logsumexp, and the shards
  combine by max and sum.
* the MLP and the dense and capacity MoE dispatches: column-parallel
  products on the rank's hidden columns, an all-reduce after.
* sequence parallelism (``ctx.seq_sharded``, `ParallelContext.
  sequence_parallel`): the residual stream between the blocks is this
  rank's (B, S/m, D) slice of the sequence. A layer's input enters its
  column-parallel products through one all-gather of the sequence
  (`enter`, where `copy_to` stands for a residual held whole) and its
  row-parallel partial sums leave through one reduce-scatter
  (`sum_partials`); a layer with no sharded form gathers the sequence,
  runs whole and keeps its slice (`whole_seq`, `to_residual`). Decode (one
  token) and a sequence the model axis does not divide keep the residual
  whole.
* the vocabulary-parallel embedding (a masked local gather and an
  all-reduce, or a reduce-scatter to the rank's slice of the sequence),
  head (local logits, gathered over the vocabulary for the rows a caller
  returns) and cross-entropy (each row's max, sum of exponentials and gold
  logit all-reduced; no logits gathered).
* the Mamba-2, RG-LRU and MLA mixers on the rank's heads or channels
  (`mixer_layer`): column-parallel input projections, the SSD (with the
  ssd_diag kernel), the doubling scan and MLA's flash prefill on the local
  heads or channels, the replicated small leaves (B, C and dt projections,
  conv kernels, gate vectors, the latent projections and norms) computed
  whole or sliced to the rank's part, the row-parallel output projection
  ending in an all-reduce. Mamba-2's gated norm spans all channels (a
  float32 all-reduce of the sums of squares), its conv state's shard does
  not line up with the heads (one all-gather of it a decode step) and an
  MLA decode attends over the whole latent cache (one all-gather of it a
  layer a step). Only where the heads or channels do not divide the model
  axis, and the rules left every leaf whole, does a mixer run as on one
  device (`replicated_layer`).

Gradients follow Megatron's rules: a tensor that the model axis holds whole
enters a column-parallel product through `copy_to` (its gradient summed),
and a row-parallel product's all-reduce passes its gradient unchanged. A
replicated leaf that a rank uses on its own slice or partial sum has a
partial gradient, summed over the model axis the same way; under sequence
parallelism that includes the leaves applied token by token to the
residual's slice (the norms, `seq_leaves`).
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.models import parallel as PAR
from repro_torch.models import rglru as RG
from repro_torch.models import ssm as SSM
from repro_torch.models.parallel import ParallelContext


def _ma(ctx):
    return ctx.model_axis


def _sharded_dim(ctx: ParallelContext, n: int) -> bool:
    return ctx.model_spec_if(n) is not None


def wide(t):
    """float32 for a narrower float. A product over this rank's share of a
    contracted dim is a partial sum: it is kept, and summed over the model
    axis, in float32, so that the whole sum rounds once to the model's
    dtype, as one device's product does."""
    return t.float() if t.dtype in (torch.bfloat16, torch.float16) else t


def sum_partials(y, ctx: ParallelContext, dtype):
    """Partial sums (B, S, ...) (float32 where the model is narrower)
    summed over the model axis, in the model's dtype: an all-reduce, or
    under sequence parallelism a reduce-scatter to this rank's slice of the
    sequence."""
    if ctx.seq_sharded:
        return PAR.scatter_seq(y, ctx, _ma(ctx), dtype)
    return PAR.all_reduce(y, ctx, _ma(ctx)).to(dtype)


def enter(x, ctx: ParallelContext):
    """A tensor at the residual stream's layout entering products on this
    rank's heads or columns: whole, its gradient summed over the model
    axis (`copy_to`; under sequence parallelism the all-gather of the
    sequence, `parallel.gather_seq`)."""
    if ctx.seq_sharded:
        return PAR.gather_seq(x, ctx, _ma(ctx))
    return PAR.copy_to(x, ctx, _ma(ctx))


def whole_seq(x, ctx: ParallelContext):
    """x at the residual's layout, whole, for work that every model rank
    runs the same (under sequence parallelism an all-gather whose backward
    keeps this rank's slice of the gradient)."""
    if ctx.seq_sharded:
        return PAR.all_gather(x, ctx, _ma(ctx), 1)
    return x


def to_residual(y, ctx: ParallelContext):
    """A result held whole and the same on every model rank, at the
    residual's layout (its slice of the sequence, whose backward gathers
    the gradient)."""
    return ctx.shard_activation(y) if ctx.seq_sharded else y


def on_whole_sequence(fn, x, ctx: ParallelContext):
    """``fn(x, ctx) -> (out, extra)`` for a layer with no sequence-parallel
    form: under sequence parallelism it runs on the gathered sequence with
    the residual held whole, the same on every model rank, and `out` is cut
    back to this rank's slice."""
    if not ctx.seq_sharded:
        return fn(x, ctx)
    out, extra = fn(whole_seq(x, ctx),
                    dataclasses.replace(ctx, seq_sharded=False))
    return to_residual(out, ctx), extra


def seq_leaves(ctx: ParallelContext, *ts):
    """Replicated leaves applied token by token to the residual stream (a
    norm's scale): under sequence parallelism each rank applies them to its
    own slice, so their gradients are summed over the model axis
    (`summed_grads`); else as they are."""
    return summed_grads(ctx, *ts) if ctx.seq_sharded else ts


# ---------------------------------------------------------------------------
# Embedding and head (vocabulary-parallel)
# ---------------------------------------------------------------------------


def embed_lookup(w, tokens, cfg: ModelConfig, ctx: ParallelContext):
    """Rows of the (V, D) table at the residual's layout, whose vocabulary
    may be split over the model axis: each rank looks up the tokens it
    holds, zeros the rest, and the ranks sum (a reduce-scatter to this
    rank's slice of the sequence under sequence parallelism; one nonzero
    term a row, so the sum is exact in the table's dtype)."""
    if w.shape[0] == cfg.vocab_size:
        return to_residual(w[tokens], ctx)
    vl = w.shape[0]
    t = tokens - ctx.axis_index(_ma(ctx)) * vl
    inside = (t >= 0) & (t < vl)
    x = w[t.clamp(0, vl - 1)] * inside[..., None].to(w.dtype)
    if ctx.seq_sharded:
        return PAR.scatter_seq(x, ctx, _ma(ctx))
    return PAR.all_reduce(x, ctx, _ma(ctx))


def lm_head(w, x, cfg: ModelConfig, ctx: ParallelContext):
    """Float32 logits over the whole vocabulary from a (V, D) head whose
    vocabulary may be split: local logits, gathered into full rows. Only
    rows that are returned reach it (a decode step's, the prefill's last):
    the loss takes `vocab_parallel_ce`, which gathers none."""
    if w.shape[0] == cfg.vocab_size:
        return x.float() @ w.float().t()
    x = PAR.copy_to(x, ctx, _ma(ctx))
    logits = x.float() @ w.float().t()
    return PAR.all_gather(logits, ctx, _ma(ctx), -1)


def vocab_parallel_ce(w, x, labels, cfg: ModelConfig, ctx: ParallelContext):
    """(summed nll over the labels >= 0, their count) of hidden states x
    (B_l, c, D) against a (V/m, D) head whose vocabulary is split over the
    model axis, without gathering logits: each rank takes the float32
    logits of its slice (softcapped), and the ranks all-reduce each row's
    max, its sum of exponentials and its gold logit (held by the rank whose
    slice has the label), (B_l, c) floats each; logz = max + log(sum).

    The gradient is one device's, by Megatron's rules: the sums' all-reduce
    passes its gradient unchanged (each model rank computes the same loss
    from them), so a rank's logits get softmax minus one-hot on its slice,
    and x is entered by the caller (`enter`, whose backward sums the
    slices' parts). The max is detached: logz does not depend on it."""
    ma = _ma(ctx)
    vl = w.shape[0]
    logits = x.float() @ w.float().t()
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    mx = PAR.all_reduce(logits.amax(-1), ctx, ma, op="max")
    sumexp = PAR.all_reduce(torch.exp(logits - mx[..., None]).sum(-1),
                            ctx, ma)
    t = labels.long() - ctx.axis_index(ma) * vl
    inside = (t >= 0) & (t < vl)
    gold = torch.gather(logits, -1, t.clamp(0, vl - 1)[..., None])[..., 0]
    gold = PAR.all_reduce(torch.where(inside, gold, 0.0), ctx, ma)
    mask = (labels >= 0).float()
    return ((mx + torch.log(sumexp) - gold) * mask).sum(), mask.sum()


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_columns(p, xin, activation: str):
    """The gated MLP on this rank's hidden columns of an entered `xin`
    (`enter`): a partial sum over the model axis (`wide`)."""
    return wide(L.mlp_hidden(p, xin, activation)) @ wide(p["w_down"])


def mlp_partial(p, x, activation: str, ctx: ParallelContext, hidden: int):
    """(y, partial): the gated MLP of x (at the residual's layout) on this
    rank's hidden columns, and whether y is a partial sum over the model
    axis (`wide`; the caller sums with `sum_partials`). Hidden units that
    do not divide the model axis run whole, y at x's layout."""
    if not _sharded_dim(ctx, hidden):
        return to_residual(L.mlp(p, whole_seq(x, ctx), activation), ctx), \
            False
    return mlp_columns(p, enter(x, ctx), activation), True


def mlp(p, x, activation: str, ctx: ParallelContext, hidden: int):
    y, partial = mlp_partial(p, x, activation, ctx, hidden)
    return sum_partials(y, ctx, x.dtype) if partial else y


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


class _Heads:
    """How a rank holds q and K/V in a sharded attention layer."""

    def __init__(self, cfg: ModelConfig, ctx: ParallelContext):
        ad = L.attn_dims(cfg)
        m = ctx.model_size
        self.h, self.hkv, self.hd = ad.n_heads, ad.n_kv_heads, ad.head_dim
        self.g = self.h // self.hkv
        self.q_sharded = _sharded_dim(ctx, self.h * self.hd)
        self.kv_sharded = _sharded_dim(ctx, self.hkv * self.hd)
        self.q_local = self.q_sharded and self.h % m == 0
        self.kv_local = (self.kv_sharded and self.q_local
                         and self.hkv % m == 0)
        r = ctx.axis_index(_ma(ctx))
        # the q-heads this rank attends with: its own, or all of them
        if self.q_local:
            self.h0, self.h1 = r * self.h // m, (r + 1) * self.h // m
        else:
            self.h0, self.h1 = 0, self.h


def kernel_shapes(cfg: ModelConfig, ctx: ParallelContext):
    """The (q-heads, kv-heads, head_dim) a rank hands the flash and decode
    kernels in `cfg`'s sharded attention layers: its own q-heads with the
    kv-heads they read (one copy a q-head where a group would split
    unevenly), and, for a decode whose cache splits its sequence over the
    model axis, every q-head on every kv-head. An MLA layer runs flash
    alone (its decode is latent matrix products), at head_dim ``nope +
    rope`` on the rank's q-heads, each with its own keys."""
    if cfg.mla is not None:
        h = cfg.n_heads
        if mixer_sharded("mla", cfg, ctx):
            h //= ctx.model_size
        d = cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
        return {"flash": (h, h, d)}
    hs = _Heads(cfg, ctx)
    hq = hs.h1 - hs.h0
    if hs.kv_local:
        hkv = hs.hkv // ctx.model_size
    else:
        k0, k1 = hs.h0 // hs.g, (hs.h1 - 1) // hs.g + 1
        even = k1 - k0 == 1 or (hs.h0 % hs.g == 0 and hq % hs.g == 0)
        hkv = k1 - k0 if even else hq
    return {"flash": (hq, hkv, hs.hd), "decode": (hq, hkv, hs.hd),
            "cp_decode": (hs.h, hs.hkv, hs.hd)}


def check_kernel_shapes(cfg: ModelConfig, ctx: ParallelContext) -> None:
    """Raise unless the kernels take every rank's attention shapes (the
    q-heads a kv-head within ``MAX_GROUP``, the head_dim in
    ``HEAD_DIMS``)."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    for name, (hq, hkv, d) in kernel_shapes(cfg, ctx).items():
        dims = fa.HEAD_DIMS if name == "flash" else dec.HEAD_DIMS
        if d not in dims:
            raise ValueError(f"{cfg.arch_id}: {name} at head_dim {d}, not "
                             f"in {dims}")
        if name != "flash":
            dec.check_group(hq, hkv)
        elif hq % hkv:
            raise ValueError(f"{cfg.arch_id}: flash at {hq} q-heads on "
                             f"{hkv} kv-heads")


def select_kv(k, v, heads: _Heads, h0: int, h1: int):
    """The kv-heads that q-heads [h0, h1) read from whole-head K/V (B, S,
    Hkv, D): a uniform group of them, or each q-head's own copy where the
    range would split a group unevenly."""
    g = heads.g
    k0, k1 = h0 // g, (h1 - 1) // g + 1
    if k1 - k0 == 1 or (h0 % g == 0 and (h1 - h0) % g == 0):
        return k[:, :, k0:k1], v[:, :, k0:k1]
    k = k.repeat_interleave(g, dim=2)[:, :, h0:h1]
    v = v.repeat_interleave(g, dim=2)[:, :, h0:h1]
    return k, v


def _match_kv(q, k, v, hs: _Heads):
    """K/V for the q-heads `q` holds: as they are, unless q holds this
    rank's heads and K/V all of them."""
    if q.shape[2] == hs.h or k.shape[2] != hs.hkv:
        return k, v
    return select_kv(k, v, hs, hs.h0, hs.h1)


def _kv_spec(cspec):
    """(seq axis, head axis, head_dim axis) of a k/v cache spec (B, S, H,
    D); None for a cache held whole."""
    if cspec is None:
        return None, None, None
    return cspec[1], cspec[2], cspec[3]


def attention_layer(p, x, *, cfg: ModelConfig, ctx: ParallelContext,
                    mode: str, cache=None, cspec=None, pos=None,
                    window: int = 0, positions=None, enc_out=None,
                    enc_cache=None, causal: bool = True):
    """`layers.attention_layer` on local shards, x at the residual's layout
    (its slice of the sequence under sequence parallelism: q, K and V are
    computed over the gathered sequence). ``cspec``: the spec of the
    cache's ``k``/``v`` (None: held whole on this rank)."""
    hs = _Heads(cfg, ctx)
    ma = _ma(ctx)
    scale = 1.0 / math.sqrt(hs.hd)
    xin = enter(x, ctx) if hs.q_sharded or hs.kv_sharded \
        else whole_seq(x, ctx)
    b, s, _ = xin.shape
    q = xin @ p["wq"]
    if hs.q_sharded and not hs.q_local:
        q = PAR.all_gather(q, ctx, ma, -1)
    q = q.view(b, s, -1, hs.hd)
    # a gathered K/V read by this rank's own q-heads has a partial gradient
    kv_grad = "sum" if hs.q_local else "split"

    def kv_of(src):
        k, v = src @ p["wk"], src @ p["wv"]
        if hs.kv_sharded and not hs.kv_local:
            k = PAR.all_gather(k, ctx, ma, -1, grad=kv_grad)
            v = PAR.all_gather(v, ctx, ma, -1, grad=kv_grad)
        shape = (b, src.shape[1], -1, hs.hd)
        return k.view(shape), v.view(shape)

    def attend(q, k, v, **kw):
        k, v = _match_kv(q, k, v, hs)
        return L.attn_op(q, k, v, scale=scale, **kw)

    if enc_out is not None or enc_cache is not None:
        if enc_cache is not None:
            k, v = _from_cache(enc_cache["k"], cspec, ctx), \
                _from_cache(enc_cache["v"], cspec, ctx)
        else:
            ein = PAR.copy_to(enc_out, ctx, ma) if hs.kv_sharded else enc_out
            k, v = kv_of(ein)
        out = attend(q, k, v, causal=False, window=0)
        return _out_proj(p, out, hs, ctx), {"k": k, "v": v}
    k, v = kv_of(xin)

    if positions is None:
        if mode == "decode":
            positions = torch.as_tensor(pos, device=x.device).reshape(-1, 1)
            positions = positions.expand(b, s)
        else:
            positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    if cfg.mrope and positions.ndim == 3:
        q = L.apply_mrope(q, positions, cfg.rope_theta)
        k = L.apply_mrope(k, positions, cfg.rope_theta)
    elif causal:
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)

    if mode in ("train", "encode") or (cache is None and mode == "prefill"):
        out = attend(q, k, v, causal=causal, window=window)
        return _out_proj(p, out, hs, ctx), None
    if mode == "prefill":
        out = attend(q, k, v, causal=True, window=window)
        _prefill_write(cache, k, v, cspec, ctx, s)
        return _out_proj(p, out, hs, ctx), cache
    if mode != "decode":
        raise ValueError(mode)
    if s != 1:
        raise ValueError(f"decode takes one token per row, got {s}")
    seq_ax, _, _ = _kv_spec(cspec)
    if seq_ax is not None:
        out = cp_decode(q, k, v, cache, cspec, pos, window, scale, hs, ctx)
    else:
        out = _decode_local(q, k, v, cache, cspec, pos, window, scale, hs,
                            ctx)
    return _out_proj(p, out, hs, ctx), cache


def _out_proj(p, out, hs: _Heads, ctx: ParallelContext):
    """The attention output (B, S, heads, D) through ``wo``: row-parallel
    over the rank's q-head columns, then summed over the model axis (at
    the residual's layout)."""
    b, s = out.shape[:2]
    o = out.reshape(b, s, -1)
    if not hs.q_sharded:
        return to_residual(o @ p["wo"], ctx)
    if o.shape[-1] == hs.h * hs.hd:        # all heads: keep this rank's
        o = PAR.split(o, ctx, _ma(ctx), -1)
    return sum_partials(wide(o) @ wide(p["wo"]), ctx, o.dtype)


@torch.no_grad()
def cache_view(t, leaf, cspec, ctx):
    """K/V (B, s, heads, D) laid out as the cache `leaf` holds its heads
    and head_dim (the sequence is placed by the caller): gathered where
    `t` holds fewer heads, sliced where it holds more."""
    _, h_ax, d_ax = _kv_spec(cspec)
    if t.shape[2] < leaf.shape[2]:
        t = PAR.all_gather(t, ctx, _ma(ctx), 2)
    elif t.shape[2] > leaf.shape[2]:
        t = PAR.local_view(t, (None, None, h_ax, None), ctx)
    if t.shape[3] > leaf.shape[3]:
        t = PAR.local_view(t, (None, None, None, d_ax), ctx)
    return t


def _from_cache(c, cspec, ctx):
    """A cache tensor with its head_dim whole (gathered where split)."""
    if cspec is None or cspec[3] is None:
        return c
    return PAR.all_gather(c, ctx, cspec[3], 3)


def _seq_slice(cache_leaf, cspec, ctx):
    """(offset, local slots, global slots) of a cache's sequence."""
    s_loc = cache_leaf.shape[1]
    seq_ax = cspec[1] if cspec is not None else None
    if seq_ax is None:
        return 0, s_loc, s_loc
    return ctx.axis_index(seq_ax) * s_loc, s_loc, s_loc * ctx.axis_size(
        seq_ax)


@torch.no_grad()
def _prefill_write(cache, k, v, cspec, ctx, s: int):
    off, s_loc, s_glob = _seq_slice(cache["k"], cspec, ctx)
    for key, t in (("k", k), ("v", v)):
        t = cache_view(t, cache[key], cspec, ctx)
        if s_glob >= s:
            n = min(max(s - off, 0), s_loc)
            if n:
                cache[key][:, :n] = t[:, off:off + n]
        else:  # rolling window smaller than the prompt: the last slots
            if s % s_glob:
                raise ValueError(f"window {s_glob} must divide the prefill "
                                 f"length {s}")
            cache[key].copy_(t[:, s - s_glob + off:s - s_glob + off + s_loc])


def _write_slot(leaf, new, slot, off: int, s_loc: int):
    """Write `new` (B, 1, ...) at global slot(s) `slot` (an int, or a (B,)
    tensor) where this shard holds them."""
    if isinstance(slot, int):
        if 0 <= slot - off < s_loc:
            leaf[:, slot - off] = new[:, 0]
        return
    local = slot - off
    owned = (local >= 0) & (local < s_loc)
    lc = local.clamp(0, s_loc - 1).long()
    rows = torch.arange(leaf.shape[0], device=leaf.device)
    cur = leaf[rows, lc]
    mask = owned.reshape((-1,) + (1,) * (cur.ndim - 1))
    leaf[rows, lc] = torch.where(mask, new[:, 0], cur)


def _valid(pos, window: int, cache_len: int, device):
    """(slot, valid slots) of a decode at `pos`: ints for an int (or a
    0-d tensor), (B,) tensors for a (B,) tensor."""
    if isinstance(pos, torch.Tensor) and pos.ndim == 0:
        pos = int(pos)
    rolling = bool(window) and window <= cache_len
    if isinstance(pos, int):
        return (pos % window if rolling else pos,
                min(pos + 1, window) if rolling else pos + 1)
    pos = pos.to(device)
    slot = pos % window if rolling else pos
    vl = torch.clamp(pos + 1, max=window) if rolling else pos + 1
    return slot, vl


def _lengths(vl, b: int, off: int, s_loc: int, device):
    """This shard's valid slots a row, (B,) int32, from the global
    count(s) `vl`."""
    if isinstance(vl, int):
        return torch.full((b,), min(max(vl - off, 0), s_loc),
                          dtype=torch.int32, device=device)
    vl = vl.reshape(-1).expand(b)
    return torch.clamp(vl - off, 0, s_loc).to(torch.int32).contiguous()


def _q_for(q, hs: _Heads, ctx, need_all: bool):
    """q with all heads when `need_all` (a decode whose shards split the
    sequence over the model axis must each see every head)."""
    if need_all and hs.q_local:
        return PAR.all_gather(q, ctx, _ma(ctx), 2)
    return q


@torch.no_grad()
def _decode_local(q, k, v, cache, cspec, pos, window, scale, hs, ctx):
    """Decode over a cache whose sequence this rank holds whole."""
    _, s_loc, s_glob = _seq_slice(cache["k"], cspec, ctx)
    slot, vl = _valid(pos, window, s_glob, q.device)
    for key, t in (("k", k), ("v", v)):
        _write_slot(cache[key], cache_view(t, cache[key], cspec, ctx), slot,
                    0, s_loc)
    kc, vc = _match_kv(q, _from_cache(cache["k"], cspec, ctx),
                       _from_cache(cache["v"], cspec, ctx), hs)
    vl = _lengths(vl, q.shape[0], 0, s_glob, q.device)
    return kops.decode_attention(q, kc, vc, vl, scale=scale)


@torch.no_grad()
def cp_decode(q, k, v, cache, cspec, pos, window, scale, hs: _Heads,
              ctx: ParallelContext):
    """Context-parallel single-token decode (flash-decoding across ranks).

    The cache's sequence is split over ``cspec[1]``: the shard that holds
    the new token's slot (``pos % window`` in a rolling window) writes it,
    each shard attends over its slice with the decode kernel, which also
    returns each row's logsumexp, and the shards combine
    ``out = sum_r exp(lse_r - max) out_r / sum_r exp(lse_r - max)``. A
    shard with no valid slot has lse = -1e30 + log(slots) and weighs
    exactly zero. pos: scalar or (B,)."""
    seq_ax = cspec[1]
    off, s_loc, s_glob = _seq_slice(cache["k"], cspec, ctx)
    slot, vl = _valid(pos, window, s_glob, q.device)
    for key, t in (("k", k), ("v", v)):
        _write_slot(cache[key], cache_view(t, cache[key], cspec, ctx), slot,
                    off, s_loc)
    # shards that split the sequence over the model axis each need every
    # q-head
    qa = _q_for(q, hs, ctx, need_all=seq_ax == _ma(ctx))
    kc, vc = _match_kv(qa, _from_cache(cache["k"], cspec, ctx),
                       _from_cache(cache["v"], cspec, ctx), hs)
    vl_loc = _lengths(vl, q.shape[0], off, s_loc, q.device)
    out, lse = kops.decode_attention(qa, kc, vc, vl_loc, scale=scale,
                                     return_lse=True)
    return cp_combine(out, lse, ctx, seq_ax)


def cp_combine(out, lse, ctx: ParallelContext, axes):
    """Merge the shards' (out (B, 1, H, D), lse (B, H)) over `axes` into
    the rows of the whole sequence (out's dtype)."""
    mx = PAR.all_reduce(lse, ctx, axes, op="max")
    w = torch.exp(lse - mx)                                    # (B, H)
    num = torch.cat([out[:, 0].float() * w[..., None], w[..., None]], -1)
    num = PAR.all_reduce(num, ctx, axes)
    res = num[..., :-1] / torch.clamp(num[..., -1:], min=1e-30)
    return res[:, None].to(out.dtype)


# ---------------------------------------------------------------------------
# Mamba-2, RG-LRU and MLA mixers on the rank's heads or channels
# ---------------------------------------------------------------------------


def _mixer_units(kind: str, cfg: ModelConfig) -> int:
    """What a mixer splits over the model axis: Mamba-2's and MLA's heads,
    RG-LRU's channels."""
    if kind == "ssm":
        return SSM._dims(cfg)[2]
    if kind == "rec":
        return RG._d_rnn(cfg)
    return cfg.n_heads


def mixer_sharded(kind: str, cfg: ModelConfig, ctx: ParallelContext) -> bool:
    """Whether a rank runs this mixer on its own heads or channels: they
    divide the model axis, so the rules split its column- and row-parallel
    leaves on whole heads (else every leaf stays whole)."""
    m = ctx.model_size
    return m > 1 and _mixer_units(kind, cfg) % m == 0


def _rank_slice(n: int, ctx: ParallelContext) -> slice:
    """This rank's slice of `n` units split evenly over the model axis."""
    c = n // ctx.model_size
    r = ctx.axis_index(_ma(ctx))
    return slice(r * c, (r + 1) * c)


def summed_grads(ctx: ParallelContext, *ts):
    """The replicated leaves `ts` as they are, their gradients summed over
    the model axis: a rank uses them on its own slice or for its partial
    sum, so its gradient is partial (one `copy_to` a dtype)."""
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in ts)):
        return ts
    out = list(ts)
    for dt in {t.dtype for t in ts}:
        idx = [i for i, t in enumerate(ts) if t.dtype == dt]
        flat = PAR.copy_to(torch.cat([ts[i].reshape(-1) for i in idx]), ctx,
                           _ma(ctx))
        for i, piece in zip(idx, flat.split([ts[i].numel() for i in idx]),
                            strict=True):
            out[i] = piece.view_as(ts[i])
    return tuple(out)


def _split_last(cspec, key) -> bool:
    return cspec is not None and cspec[key][-1] is not None


def _gather_pieces(pieces, ctx: ParallelContext):
    """All-gather several tensors of (B, ...) over the model axis in one
    call: per tensor, the ranks' pieces stacked on a new leading dim (m,
    B, ...)."""
    b = pieces[0].shape[0]
    flat = torch.cat([t.reshape(b, -1) for t in pieces], dim=-1)
    g = PAR.all_gather(flat[None], ctx, _ma(ctx), 0)
    out, i = [], 0
    for t in pieces:
        n = t[0].numel()
        out.append(g[..., i:i + n].reshape((g.shape[0],) + tuple(t.shape)))
        i += n
    return out


def _join_last(stacked):
    """(m, B, ..., c) pieces of a last dim split over the model axis ->
    (B, ..., m * c)."""
    return torch.cat(stacked.unbind(0), dim=-1)


def rglru_layer(p, x, *, cfg: ModelConfig, ctx: ParallelContext, mode: str,
                cache=None, cspec=None):
    """`rglru.rglru_layer` on this rank's ``d_rnn / m`` channels: the gate
    and input projections' columns, the conv kernel and gate vectors
    sliced to them, the cache's ``h``/``conv`` shards as they lie, and the
    row-parallel output projection."""
    sl = _rank_slice(RG._d_rnn(cfg), ctx)
    xin = enter(x, ctx)
    gate = F.gelu(xin @ p["w_gate_in"], approximate="tanh")
    names = ("conv", "w_a", "b_a", "w_x", "b_x", "lam")
    rep = summed_grads(ctx, *(p[n] for n in names))
    local = {n: t[..., sl] for n, t in zip(names, rep, strict=True)}
    y, new_cache = RG.recurrence(local, xin @ p["w_rec_in"], mode=mode,
                                 cache=cache)
    y = (gate.float() * y).to(x.dtype)
    return sum_partials(wide(y) @ wide(p["out_proj"]), ctx, x.dtype), \
        new_cache


def ssm_layer(p, x, *, cfg: ModelConfig, ctx: ParallelContext, mode: str,
              cache=None, cspec=None):
    """`ssm.ssm_layer` on this rank's ``H / m`` heads (their ``wz``/``wx``
    columns, ``dt``, ``A``, ``D``, conv channels and the SSD with the
    ssd_diag kernel); the B and C projections (one group, shared by every
    head) computed whole. The conv state's shard (its channels split
    evenly, which does not line up with [x | B | C]) is gathered whole
    with the step's x row in one all-gather a decode step, and the rank's
    shard of the new state written back. The gated norm spans all channels:
    its sums of squares are summed over the model axis in float32."""
    s_cfg, di, nh = SSM._dims(cfg)
    n, hd, k = s_cfg.d_state, s_cfg.head_dim, s_cfg.d_conv
    hs = _rank_slice(nh, ctx)
    cs = slice(hs.start * hd, hs.stop * hd)
    ma = _ma(ctx)
    xin = enter(x, ctx)
    b, s, _ = xin.shape
    wB, wC, w_dt, dt_bias, A_log, D, kern, scale = summed_grads(
        ctx, p["wB"], p["wC"], p["w_dt"], p["dt_bias"], p["A_log"], p["D"],
        p["conv"], p["norm"]["scale"])
    z = xin @ p["wz"]
    xl = xin @ p["wx"]
    Bm, Cm = xin @ wB, xin @ wC
    dt = F.softplus((xin @ w_dt).float() + dt_bias)[..., hs]
    A = -torch.exp(A_log[hs])
    conv_in = torch.cat([xl, Bm, Cm], dim=-1)
    kern = torch.cat([kern[:, cs], kern[:, di:]], dim=-1)

    new_cache = None
    if mode == "decode":
        with torch.no_grad():
            if _split_last(cspec, "conv"):
                old, row = _gather_pieces([cache["conv"], xl], ctx)
                old, row = _join_last(old), _join_last(row)
            else:
                old, row = cache["conv"], PAR.all_gather(xl, ctx, ma, -1)
        state = torch.cat([old[..., cs], old[..., di:]], dim=-1)
        conv_out, _ = SSM._causal_conv(conv_in, kern, state)
        y, st = SSM.ssd_mix(conv_out, dt, A, D[hs], s_cfg=s_cfg, mode=mode,
                            state=cache["state"], dtype=x.dtype)
        with torch.no_grad():
            whole = torch.cat([old, torch.cat([row, Bm, Cm], -1)], 1)[:, 1:]
            cache["state"].copy_(st)
            cache["conv"].copy_(_conv_shard(whole, cspec, ctx))
        new_cache = cache
    else:
        conv_out, _ = SSM._causal_conv(conv_in, kern)
        y, final_state = SSM.ssd_mix(conv_out, dt, A, D[hs], s_cfg=s_cfg,
                                     mode=mode, dtype=x.dtype)
        if mode == "prefill" and cache is not None:
            with torch.no_grad():
                keep = min(k - 1, s)
                tail = torch.cat([PAR.all_gather(xl[:, s - keep:], ctx, ma,
                                                 -1),
                                  Bm[:, s - keep:], Cm[:, s - keep:]], -1)
                cache["state"].copy_(final_state)
                cache["conv"].zero_()
                cache["conv"][:, k - 1 - keep:] = _conv_shard(tail, cspec,
                                                              ctx)
            new_cache = cache

    g = (y * F.silu(z)).float()
    ss = PAR.all_reduce(g.square().sum(-1, keepdim=True), ctx, ma,
                        grad="sum")
    g = g * torch.rsqrt(ss / di + 1e-6) * (1.0 + scale[cs])
    y = g.to(torch.promote_types(y.dtype, z.dtype)).to(x.dtype)
    return sum_partials(wide(y) @ wide(p["out_proj"]), ctx, x.dtype), \
        new_cache


def _conv_shard(t, cspec, ctx):
    """This rank's shard of a whole conv-state tensor (..., C)."""
    if not _split_last(cspec, "conv"):
        return t
    return PAR.local_view(t, (None,) * (t.ndim - 1) + (_ma(ctx),), ctx)


def mla_layer(p, x, *, cfg: ModelConfig, ctx: ParallelContext, mode: str,
              cache=None, cspec=None, pos=None, positions=None):
    """`layers.mla_layer` on this rank's ``H / m`` heads (their ``wq_b``,
    ``wkv_b`` and ``wo`` columns and rows; the flash prefill on them). The
    latents (``wq_a``, ``wkv_a`` and both norms, replicated) are computed
    at the residual's layout (under sequence parallelism on the rank's
    slice, their leaves' gradients summed over the model axis) and enter
    the rank's products together (`enter`). The cache's ``ckv``/``krope``
    shards (their last dims over the model axis) take the rank's part of
    the new rows; a decode gathers them whole (one all-gather a layer a
    step), since the absorbed decode reads every slot's whole latent. An
    MLA without q-LoRA (``q_lora_rank`` 0: one ``wq``, no query latent)
    has no sharded form here, and is refused."""
    if not cfg.mla.q_lora_rank:
        raise NotImplementedError(
            f"{cfg.arch_id}: the sharded MLA mixer takes q-LoRA (wq_a, "
            f"wq_b); q_lora_rank 0 has no sharded form")
    ma = _ma(ctx)
    if ctx.seq_sharded:
        b, s = x.shape[0], x.shape[1] * ctx.model_size
        if positions is None:
            positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
        lat_pos = PAR.local_view(positions, (None, ma), ctx)
    else:
        b, s, _ = x.shape
        positions = lat_pos = L.mla_positions(x, mode, pos, positions)
    wq_a, wkv_a, qn, kvn = seq_leaves(ctx, p["wq_a"], p["wkv_a"],
                                      p["q_norm"]["scale"],
                                      p["kv_norm"]["scale"])
    lat = L.mla_latents({"wq_a": wq_a, "wkv_a": wkv_a,
                         "q_norm": {"scale": qn}, "kv_norm": {"scale": kvn}},
                        x, cfg=cfg, positions=lat_pos)
    cq, ckv, krope = enter(torch.cat(lat, -1), ctx).split(
        [t.shape[-1] for t in lat], -1)
    q_nope, q_rope = L.mla_queries(cq, p["wq_b"], cfg=cfg,
                                   positions=positions)

    def shard(t, key):
        if not _split_last(cspec, key):
            return t
        return PAR.local_view(t, (None, None, ma), ctx)

    new_cache = None
    if mode == "decode":
        if s != 1:
            raise ValueError(f"decode takes one token per row, got {s}")
        with torch.no_grad():
            L.update_cache_seq(cache["ckv"], shard(ckv, "ckv"), pos)
            L.update_cache_seq(cache["krope"], shard(krope, "krope"), pos)
            keys = [key for key in ("ckv", "krope") if _split_last(cspec,
                                                                   key)]
            whole = dict(cache)
            if keys:
                got = _gather_pieces([cache[key] for key in keys], ctx)
                whole.update({key: _join_last(g)
                              for key, g in zip(keys, got, strict=True)})
        new_cache = cache
        out = L.mla_absorbed_decode(p["wkv_b"], q_nope, q_rope, whole["ckv"],
                                    whole["krope"], pos, cfg=cfg)
    else:
        if mode == "prefill" and cache is not None:
            with torch.no_grad():
                cache["ckv"][:, :s] = shard(ckv, "ckv")
                cache["krope"][:, :s] = shard(krope, "krope")
            new_cache = cache
        out = L.mla_prefill_attention(p["wkv_b"], q_nope, q_rope, ckv,
                                      krope, cfg=cfg)
    out = out.reshape(b, s, -1)
    return sum_partials(wide(out) @ wide(p["wo"]), ctx, x.dtype), new_cache


_MIXERS = {"ssm": ssm_layer, "rec": rglru_layer, "mla": mla_layer}


def _whole_cache_specs(cache, ctx: ParallelContext):
    """The model-axis specs of a mixer's cache held whole (no batch split),
    by leaf name as `launch.shardings.cache_specs_tree` cuts it: ``state``
    on its heads, every other leaf on its last dim."""
    def one(name, t):
        spec = [None] * t.ndim
        dim = 1 if name == "state" else t.ndim - 1
        if t.shape[dim] % ctx.model_size == 0:
            spec[dim] = ctx.model_axis
        return tuple(spec)
    return {key: one(key, t) for key, t in cache.items()}


def mixer_layer(kind: str, p, x, *, cfg: ModelConfig, ctx: ParallelContext,
                mode: str, cache=None, cspec=None, pos=None, positions=None):
    """A Mamba-2 (``ssm``), RG-LRU (``rec``) or MLA (``mla``) mixer on this
    rank's shards (`mixer_sharded` must hold). A cache held whole (no
    ``cspec``) is cut to this rank's shard for the layer and gathered back
    after it."""
    fn = _MIXERS[kind]
    kw = dict(cfg=cfg, ctx=ctx, mode=mode)
    if kind == "mla":
        kw.update(pos=pos, positions=positions)
    if cache is None or cspec is not None:
        return fn(p, x, cache=cache, cspec=cspec, **kw)
    specs = _whole_cache_specs(cache, ctx)
    with torch.no_grad():
        local = {key: PAR.local_view(t, specs[key], ctx).clone()
                 for key, t in cache.items()}
    out, new_cache = fn(p, x, cache=local, cspec=specs, **kw)
    if new_cache is None:
        return out, None
    with torch.no_grad():
        for key, t in cache.items():
            t.copy_(PAR.gather_tree(local[key], specs[key], ctx))
    return out, cache


# ---------------------------------------------------------------------------
# Layers without a sharded form: gathered, then run as on one device
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _layer_specs(cfg: ModelConfig, spec, mesh_key):
    from repro_torch.models import transformer as T
    shapes = T.init_layer(None, spec, cfg, "meta")
    shape, names = mesh_key
    ctx = ParallelContext(mesh=PAR.Mesh.abstract(shape, names))
    return PAR.param_specs(shapes, ctx)


def layer_param_specs(cfg: ModelConfig, spec, ctx: ParallelContext):
    """`param_specs` of one layer's parameters (the model axis named
    "model", as the rules name it)."""
    mesh = ctx.mesh
    return _layer_specs(cfg, spec, (mesh.devices_shape, mesh.axis_names))


def replicated_layer(fn, p, x, cache, cspecs, pspecs, ctx: ParallelContext):
    """Run ``fn(p_whole, x, cache_whole)`` with the parameters, cache and
    (under sequence parallelism) the sequence gathered over the model axis,
    then keep this rank's cache shard and slice of the output."""
    ma = _ma(ctx)
    pw = PAR.gather_tree(p, pspecs, ctx, axes=ma)
    cw = None
    if cache is not None:
        with torch.no_grad():
            cw = PAR.gather_tree(cache, cspecs, ctx, axes=ma) \
                if cspecs is not None else cache
    out, new_cache = fn(pw, whole_seq(x, ctx), cw)
    out = to_residual(out, ctx)
    if cache is not None and cspecs is not None and new_cache is not None:
        with torch.no_grad():
            for key, leaf in cache.items():
                spec = tuple(e if e == ma else None for e in cspecs[key])
                leaf.copy_(PAR.local_view(new_cache[key], spec, ctx))
        new_cache = cache
    return out, new_cache
