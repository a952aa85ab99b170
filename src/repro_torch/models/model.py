"""Public model API: init / forward / loss / prefill / decode, per config.

Parameters are a plain dict: ``embed`` (V, D), ``layers`` (one dict per
layer, in execution order), ``final_norm``, for untied models ``unembed``,
for VLMs ``vision_proj`` (D, D), the stub vision tower's projection, and
for encoder-decoder models ``encoder`` ({"layers": [...], "norm"}).
``init_params`` draws from a seeded ``torch.Generator`` with the JAX
package's distributions and scales (not its bits: ``convert.py`` carries
JAX weights over when the two must agree).
"""
from __future__ import annotations

import functools
import math

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import parallel as PAR
from repro_torch.models import transformer as T
from repro_torch.models.parallel import resolve_device
from repro_torch.obs.spans import model_range

# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, seed: int = 0, device=None, ctx=None):
    """Random weights for `cfg` on `device` (CUDA unless named). Under a
    mesh (``ctx``) only this rank's shards are kept: each leaf is drawn
    whole from the same generator stream, one layer at a time, cut by
    `parallel.param_specs` and freed, so every rank holds the values of
    the single-device draw."""
    dev = resolve_device(device)
    # the meta device (`params_shapes`) draws nothing
    gen = None if dev.type == "meta" \
        else torch.Generator(device=dev).manual_seed(seed)
    dt = L.torch_dtype(cfg.dtype)
    if PAR.is_sharded(ctx):
        specs = PAR.param_specs(params_shapes(cfg), ctx)

        def place(tree, spec):
            return PAR.shard_tree(tree, spec, ctx)
    else:
        specs = None

        def place(tree, spec):
            return tree

    def at(key, i=None):
        if specs is None:
            return None
        return specs[key] if i is None else specs[key][i]

    params = {"embed": place(L.dense_init(
        gen, (cfg.vocab_size, cfg.d_model), scale=0.02, dtype=dt,
        device=dev), at("embed"))}
    params["layers"] = [
        place(T.init_layer(gen, spec, cfg, dev), at("layers", i))
        for i, spec in enumerate(T.block_program(cfg).layers())]
    params["final_norm"] = L.init_rmsnorm(cfg.d_model, dev)
    if not cfg.tie_embeddings:
        params["unembed"] = place(L.dense_init(
            gen, (cfg.vocab_size, cfg.d_model),
            scale=1.0 / math.sqrt(cfg.d_model), dtype=dt, device=dev),
            at("unembed"))
    if cfg.enc_dec:
        params["encoder"] = place(T.init_encoder(gen, cfg, dev),
                                  at("encoder"))
    if cfg.vision_tokens:
        params["vision_proj"] = place(L.dense_init(
            gen, (cfg.d_model, cfg.d_model), scale=0.02, dtype=dt,
            device=dev), at("vision_proj"))
    return params


def params_shapes(cfg: ModelConfig):
    """The parameter tree of `cfg` on the meta device: shapes and dtypes,
    no memory."""
    return init_params(cfg, device="meta")


def decayed_leaves(cfg: ModelConfig) -> list:
    """Whether the JAX package's AdamW decays each parameter of `cfg`, in
    `leaves` order. It decays leaves of two or more dims, and it holds a
    scanned superblock's layers and whisper's encoder layers stacked along
    a layer dim (`init_stack`, `init_encoder`), so that there a norm's
    scale or a bias decays too; the port holds one dict a layer and counts
    that dim here."""
    from repro_torch.training.optimizer import leaves, tree_map
    shapes = params_shapes(cfg)
    prog = T.block_program(cfg)
    lo = len(prog.head)
    hi = lo + len(prog.superblock) * prog.n_superblocks

    def decayed(tree, stacked):
        return tree_map(lambda t: t.ndim + stacked >= 2, tree)
    flags = {k: decayed(v, 0) for k, v in shapes.items()}
    flags["layers"] = [decayed(p, int(lo <= i < hi))
                       for i, p in enumerate(shapes["layers"])]
    if "encoder" in shapes:
        flags["encoder"]["layers"] = decayed(shapes["encoder"]["layers"], 1)
    return leaves(flags)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def embed_tokens(params, tokens, cfg: ModelConfig, ctx=None):
    if PAR.is_sharded(ctx):
        from repro_torch.models import tp as TP
        x = TP.embed_lookup(params["embed"], tokens, cfg, ctx)
    else:
        x = params["embed"][tokens]
    if cfg.family in ("dense", "hybrid", "vlm") and cfg.tie_embeddings:
        # gemma-family convention: scale token embeddings by sqrt(d), in the
        # embedding's own dtype
        x = x * _embed_scale(cfg.d_model, x.dtype)
    return x


@functools.lru_cache(maxsize=None)
def _embed_scale(d_model: int, dtype: torch.dtype) -> float:
    """sqrt(d_model) rounded to `dtype`, as a Python number, made once: a
    tensor made from it at every call would be a copy to the device, which
    a CUDA graph cannot capture. The product is the same as with a tensor
    of `dtype` (its value is exact in the products' float32 and float64)."""
    return float(torch.tensor(math.sqrt(d_model), dtype=dtype))


def embed_inputs(params, batch, cfg: ModelConfig, ctx=None):
    """Token embeddings; for a VLM given ``vision_embeds`` (B, n, D), the
    first n positions take ``vision_embeds @ vision_proj`` instead (the
    stub vision tower), as in the JAX package. Under sequence parallelism
    (``ctx.seq_sharded``) the rows of this rank's slice of the sequence:
    the JAX package shards after the splice, and the slice takes the
    vision rows that fall in it (``vision_proj``'s gradient summed over the
    model axis)."""
    x = embed_tokens(params, batch["tokens"], cfg, ctx)
    if cfg.vision_tokens and "vision_embeds" in batch:
        e, w = batch["vision_embeds"], params["vision_proj"]
        sp = PAR.is_sharded(ctx) and ctx.seq_sharded
        if sp:
            from repro_torch.models import tp as TP
            w, = TP.seq_leaves(ctx, w)
        dt = torch.promote_types(e.dtype, w.dtype)
        v = e.to(dt) @ w.to(dt)
        if not sp:
            return torch.cat([v.to(x.dtype), x[:, v.shape[1]:]], dim=1)
        # every rank's v takes part (a zero gradient where no vision row
        # falls in the slice), so that every rank sums the gradient
        s_loc, n = x.shape[1], v.shape[1]
        o = ctx.axis_index(ctx.model_axis) * s_loc
        vl = torch.nn.functional.pad(v, (0, 0, 0, max(o + s_loc - n, 0)))
        inside = torch.arange(o, o + s_loc, device=x.device) < n
        x = torch.where(inside[None, :, None], vl[:, o:o + s_loc].to(x.dtype),
                        x)
    return x


def encode(params, batch, cfg: ModelConfig, mode: str = "train", ctx=None):
    """The encoder's output (B, S_enc, D) for an encoder-decoder model's
    ``audio_frames``, in every mode but decode (decode never re-encodes:
    the cross keys and values were cached at prefill); None otherwise. The
    frames must be in the model's dtype (the JAX package promotes mixed
    operands; torch's matrix products refuse them)."""
    if not cfg.enc_dec or mode == "decode":
        return None
    frames = batch["audio_frames"]
    want = params["embed"].dtype
    if frames.dtype != want:
        raise TypeError(f"audio_frames are {frames.dtype}; the model takes "
                        f"{want} frames")
    if PAR.is_sharded(ctx):
        return T.run_encoder(params["encoder"], frames, cfg=cfg, ctx=ctx)
    return T.run_encoder(params["encoder"], frames, cfg=cfg)


def lm_head(params, x, cfg: ModelConfig, ctx=None):
    """Logits in float32, with the optional tanh softcap (over the whole
    vocabulary under a mesh too: gathered where it is split)."""
    w = params["embed"] if cfg.tie_embeddings else params["unembed"]
    with model_range("model.head"):
        if PAR.is_sharded(ctx):
            from repro_torch.models import tp as TP
            logits = TP.lm_head(w, x, cfg, ctx)
        else:
            logits = x.float() @ w.float().t()
        if cfg.logit_softcap:
            c = cfg.logit_softcap
            logits = c * torch.tanh(logits / c)
    return logits


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def _dispatch(ctx, moe_dispatch: str) -> str:
    return ctx.moe_dispatch if ctx is not None else moe_dispatch


def _local_batch(batch, ctx):
    """This rank's rows of a global batch (``positions`` is (3, B, S))."""
    return {k: ctx.shard_batch(v, 1 if k == "positions" else 0)
            for k, v in batch.items()}


def _local_pos(pos, b: int, ctx):
    if isinstance(pos, torch.Tensor) and pos.ndim == 1 and pos.shape[0] == b:
        return ctx.shard_batch(pos)
    return pos


def _global_rows(x, b: int, ctx, dim: int = 0):
    """Rows of every data rank, where the global batch of `b` was split."""
    if PAR.is_sharded(ctx) and ctx.batch_sharded(b):
        return PAR.all_gather(x, ctx, ctx.batch_spec, dim)
    return x


def _hidden(params, batch, *, cfg: ModelConfig, mode: str, cache, pos,
            moe_dispatch: str, remat: bool, ctx, block=None):
    """`hidden_states` at the residual's layout: (x, cache', aux, the
    context of the forward). Under a mesh the context is
    ``ctx.sequence_parallel(S)``: where it is ``seq_sharded``, x is this
    rank's (B_local, S/m, D) slice of the sequence (the encoder, which the
    JAX package does not shard, runs whole first). ``block``: the
    published settings `models.block.Block` (None: the JAX package's
    model)."""
    if block is not None:
        block.check(cfg)
    if PAR.is_sharded(ctx):
        b = batch["tokens"].shape[0]
        batch, pos = _local_batch(batch, ctx), _local_pos(pos, b, ctx)
    else:
        moe_dispatch, ctx = _dispatch(ctx, moe_dispatch), None
    enc_out = encode(params, batch, cfg, mode, ctx)
    final_scale = params["final_norm"]["scale"]
    if ctx is not None:
        from repro_torch.models import tp as TP
        ctx = ctx.sequence_parallel(batch["tokens"].shape[1])
        final_scale, = TP.seq_leaves(ctx, final_scale)
    x = embed_inputs(params, batch, cfg, ctx)
    x, new_cache, aux = T.run_stack(
        params["layers"], x, cfg=cfg, mode=mode, cache=cache, pos=pos,
        positions=batch.get("positions"), moe_dispatch=moe_dispatch,
        enc_out=enc_out, remat=remat, ctx=ctx, block=block)
    x = L.rmsnorm({"scale": final_scale}, x, cfg.norm_eps)
    return x, new_cache, aux, ctx


def hidden_states(params, batch, *, cfg: ModelConfig, mode: str = "train",
                  cache=None, pos=None, moe_dispatch: str = "dense",
                  remat: bool = False, ctx=None, block=None):
    """`forward` without its head: (the final normed hidden states (B, S,
    D), cache', aux), so that a caller runs the head on the rows it wants;
    aux is `transformer.run_stack`'s (the MoE load-balance loss). Under a
    mesh (``ctx``) the batch is global and the states are this rank's rows
    (B_local, S, D), gathered whole where the forward split the
    sequence."""
    x, new_cache, aux, ctx = _hidden(
        params, batch, cfg=cfg, mode=mode, cache=cache, pos=pos,
        moe_dispatch=moe_dispatch, remat=remat, ctx=ctx, block=block)
    if ctx is not None:
        from repro_torch.models import tp as TP
        x = TP.whole_seq(x, ctx)
    return x, new_cache, aux


def forward(params, batch, *, cfg: ModelConfig, mode: str = "train",
            cache=None, pos=None, moe_dispatch: str = "dense", ctx=None,
            block=None):
    """batch: {"tokens": (B, S) integer [, "positions": (B, S), or (3, B,
    S) for M-RoPE] [, "vision_embeds": (B, n, D) for a VLM] [,
    "audio_frames": (B, S_enc, D) for an encoder-decoder model, but at
    decode]}.

    Returns (logits (B, S, V) float32, cache'). The cache is updated in
    place. ``moe_dispatch`` picks the MoE layers' dispatch, "dense" or
    "capacity", as the JAX package's ``ParallelContext.moe_dispatch``; a
    ``ctx`` gives it instead. ``block`` holds published settings the
    config does not (`models.block.Block`: the MoE gate rule, MLA's rotary
    scaling). The MoE load-balance loss is `loss_fn`'s (serving ignores it,
    as the JAX engine does).

    Under a mesh (``ctx``) the parameters and cache are this rank's shards
    and the batch is global: each rank runs its rows (their whole
    sequence) and the logits of every row are gathered."""
    x, new_cache, _ = hidden_states(params, batch, cfg=cfg, mode=mode,
                                    cache=cache, pos=pos,
                                    moe_dispatch=moe_dispatch, ctx=ctx,
                                    block=block)
    logits = lm_head(params, x, cfg, ctx)
    return _global_rows(logits, batch["tokens"].shape[0], ctx), new_cache


CE_CHUNK = 512


def ce_from_hidden(params, x, labels, cfg: ModelConfig, ctx=None):
    """Softmax cross-entropy straight from the final hidden states, a
    sequence chunk of ``min(CE_CHUNK, S)`` at a time (one chunk when that
    does not divide S), each under `torch.utils.checkpoint`, so no chunk's
    (B, c, V) float32 logits live on into the backward. Labels below 0 are
    masked. Under a mesh whose model axis splits the head's vocabulary each
    chunk is `tp.vocab_parallel_ce`: no logits cross the ranks. Under a
    mesh x is at the residual's layout of ``ctx`` and is gathered over the
    sequence (in its dtype) first where the forward split it. Returns
    (summed nll, count), float32."""
    w = params["embed"] if cfg.tie_embeddings else params["unembed"]
    vocab_split = PAR.is_sharded(ctx) and w.shape[0] != cfg.vocab_size
    if PAR.is_sharded(ctx):
        from repro_torch.models import tp as TP
        x = TP.enter(x, ctx) if vocab_split else TP.whole_seq(x, ctx)
    s = x.shape[1]
    chunk = min(CE_CHUNK, s)
    if s % chunk:
        chunk = s

    def piece(xc, lc):
        if vocab_split:
            return TP.vocab_parallel_ce(w, xc, lc, cfg, ctx)
        logits = lm_head(params, xc, cfg, ctx)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            lc.long().clamp(min=0)[..., None])[..., 0]
        mask = (lc >= 0).float()
        return ((logz - gold) * mask).sum(), mask.sum()

    nll = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, chunk):
        n, c = torch.utils.checkpoint.checkpoint(
            piece, x[:, c0:c0 + chunk], labels[:, c0:c0 + chunk],
            use_reentrant=False)
        nll, cnt = nll + n, cnt + c
    return nll, cnt


def loss_fn(params, batch, *, cfg: ModelConfig, aux_weight: float = 0.01,
            moe_dispatch: str = "dense", remat: bool = False, ctx=None,
            block=None):
    """Mean next-token cross-entropy over the labels >= 0, plus
    ``aux_weight`` times the MoE load-balance loss. batch: `forward`'s
    train batch with ``labels`` (B, S). ``remat`` checkpoints each layer
    (a ``ctx`` gives the dispatch and ``remat`` instead). Under a mesh the
    batch is global and each rank runs its rows; the loss is the global
    batch's on every rank. Returns (total, {"loss", "moe_aux_loss"})."""
    if ctx is not None:
        moe_dispatch, remat = ctx.moe_dispatch, ctx.remat
    x, _, aux, fctx = _hidden(params, batch, cfg=cfg, mode="train",
                              cache=None, pos=None,
                              moe_dispatch=moe_dispatch, remat=remat,
                              ctx=ctx, block=block)
    labels, b = batch["labels"], batch["tokens"].shape[0]
    if PAR.is_sharded(ctx):
        labels = ctx.shard_batch(labels)
    nll, cnt = ce_from_hidden(params, x, labels, cfg, fctx)
    if PAR.is_sharded(ctx) and ctx.batch_sharded(b):
        both = PAR.all_reduce(torch.stack([nll, cnt]), ctx, ctx.batch_spec)
        nll, cnt = both[0], both[1]
    loss = nll / torch.clamp(cnt, min=1.0)
    total = loss + aux_weight * aux["moe_aux_loss"]
    return total, {"loss": loss, "moe_aux_loss": aux["moe_aux_loss"]}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device=None, ctx=None, context_parallel: bool = False):
    """One cache dict per layer: attention {"k", "v"} of (batch, slots, Hkv,
    D), MLA {"ckv", "krope"} of (batch, slots, rank), Mamba-2 {"state",
    "conv"}. ``device="meta"`` gives the shapes alone (the paged cache
    probes them). Under a mesh (``ctx``) this rank's shards of each leaf,
    cut by `launch.shardings.cache_specs_tree` (``context_parallel``: the
    long-context decode's sequence over "data"), as a
    `parallel.ShardedCache` that carries the specs."""
    dev = resolve_device(device)
    if not PAR.is_sharded(ctx):
        return T.init_stack_cache(cfg, batch, max_seq, dtype=dtype,
                                  device=dev)
    from repro_torch.launch.shardings import cache_specs_tree
    specs = cache_specs_tree(cfg, ctx, batch, max_seq, context_parallel)
    shapes = T.init_stack_cache(cfg, batch, max_seq, dtype=dtype,
                                device="meta")
    local = PAR.map_trees(
        lambda t, sp: torch.zeros(PAR.local_shape(t.shape, sp, ctx),
                                  dtype=t.dtype, device=dev), shapes, specs)
    return PAR.ShardedCache(local, specs)


def input_specs(cfg: ModelConfig, shape, dtype=torch.bfloat16):
    """Every model input of (cfg, shape) as a meta tensor, as the JAX
    package's ``input_specs``: train {tokens, labels}, prefill {tokens},
    decode {tokens (B, 1)}, with M-RoPE's (3, B, S) positions, a VLM's
    vision embeddings and an encoder-decoder model's audio frames."""
    b, s, kind = shape.global_batch, shape.seq_len, shape.kind

    def sds(shp, dt):
        return torch.empty(shp, dtype=dt, device="meta")

    out = {}
    if kind == "train":
        out["tokens"] = sds((b, s), torch.int32)
        out["labels"] = sds((b, s), torch.int32)
    else:
        out["tokens"] = sds((b, s) if kind == "prefill" else (b, 1),
                            torch.int32)
    seq_here = 1 if kind == "decode" else s
    if cfg.mrope:
        out["positions"] = sds((3, b, seq_here), torch.int32)
    if cfg.vision_tokens and kind != "decode":
        out["vision_embeds"] = sds((b, cfg.vision_tokens, cfg.d_model), dtype)
    if cfg.enc_dec and kind != "decode":
        enc_len = s if kind == "train" else cfg.encoder_seq_len
        enc_len = min(s, 32768) if kind == "prefill" else enc_len
        out["audio_frames"] = sds((b, enc_len, cfg.d_model), dtype)
    return out


def prefill(params, batch, cache, *, cfg: ModelConfig, last=-1,
            moe_dispatch: str = "dense", ctx=None, block=None):
    """Run the prompt through the stack and fill the cache; the head runs
    on row ``last`` alone: an int, or a (B,) index tensor, one position a
    row (the engine's bucket prefill passes the prompt's last token, as
    the JAX engine's ``_prefill_cache(p, batch, c, last)`` does).

    Returns (logits of row `last` (B, V) float32, cache'). Under a mesh
    each rank runs the head on its own rows, gathers their vocabulary and
    then the rows; where the forward split the sequence, the row `last`
    lies on one rank's slice, and only that row crosses the model axis."""
    x, new_cache, _, fctx = _hidden(params, batch, cfg=cfg, mode="prefill",
                                    cache=cache, pos=None,
                                    moe_dispatch=moe_dispatch, remat=False,
                                    ctx=ctx, block=block)
    b = batch["tokens"].shape[0]
    if isinstance(last, torch.Tensor) and last.ndim:
        last = last.to(x.device).long()
        if PAR.is_sharded(ctx):
            last = _local_pos(last, b, ctx)
    if fctx is not None and fctx.seq_sharded:
        x = _row_of_slices(x, last, fctx)
    else:
        x = x[torch.arange(x.shape[0], device=x.device), last]
    logits = lm_head(params, x[:, None], cfg, ctx)[:, 0]
    return _global_rows(logits, b, ctx), new_cache


def _row_of_slices(x, last, ctx):
    """Row `last` (an int, or one position a row) of the sequence whose
    slices (B, S/m, D) the model ranks hold: the rank that holds it gives
    it, the others zeros, and one (B, D) all-reduce sums them (exactly)."""
    b, s_loc = x.shape[0], x.shape[1]
    s = s_loc * ctx.model_size
    idx = torch.as_tensor(last, device=x.device).long().expand(b) % s
    local = idx - ctx.axis_index(ctx.model_axis) * s_loc
    owned = (local >= 0) & (local < s_loc)
    row = x[torch.arange(b, device=x.device), local.clamp(0, s_loc - 1)]
    row = torch.where(owned[:, None], row, torch.zeros_like(row))
    return PAR.all_reduce(row, ctx, ctx.model_axis)


def decode_step(params, tokens, cache, pos, *, cfg: ModelConfig,
                moe_dispatch: str = "dense", batch_extras=None, ctx=None,
                block=None):
    """One decode step. tokens: (B, 1); pos: int or (B,) current positions
    (for M-RoPE all three streams take ``pos``, as in the JAX package);
    ``batch_extras`` joins the batch (an encoder-decoder model's frames are
    not re-encoded: decode reads the cross keys and values its prefill
    cached).

    Returns (logits (B, V), cache')."""
    batch = {"tokens": tokens}
    if batch_extras:
        batch.update(batch_extras)
    if cfg.mrope and "positions" not in batch:
        b = tokens.shape[0]
        batch["positions"] = torch.as_tensor(
            pos, dtype=torch.int32, device=tokens.device).reshape(
                1, -1, 1).expand(3, b, 1)
    logits, new_cache = forward(params, batch, cfg=cfg,
                                mode="decode", cache=cache, pos=pos,
                                moe_dispatch=moe_dispatch, ctx=ctx,
                                block=block)
    return logits[:, -1], new_cache


def greedy_generate(params, prompts, *, cfg: ModelConfig, steps: int,
                    max_seq: int, extras=None):
    """Greedy decoding at the model level, without an engine (the serving
    path of an encoder-decoder model, which no engine takes): each prompt
    prefilled alone at its own length with its rows of ``extras`` (e.g.
    ``audio_frames``), the caches joined, then `steps` decode steps of all
    rows at once with a (B,) position vector. Returns each prompt's
    ``steps + 1`` new tokens."""
    dev = params["embed"].device
    caches, tok = [], []
    for i, prompt in enumerate(prompts):
        batch = {"tokens": torch.tensor([prompt], device=dev)}
        batch.update({k: v[i:i + 1] for k, v in (extras or {}).items()})
        logits, cache = prefill(params, batch, init_cache(
            cfg, 1, max_seq, device=dev), cfg=cfg)
        caches.append(cache)
        tok.append(logits.argmax(-1, keepdim=True))
    cache = [{k: torch.cat([c[j][k] for c in caches]) for k in caches[0][j]}
             for j in range(len(caches[0]))]
    del caches
    tok = torch.cat(tok)
    pos = torch.tensor([len(p) for p in prompts], device=dev)
    out = [tok]
    for _ in range(steps):
        logits, cache = decode_step(params, tok, cache, pos, cfg=cfg)
        tok = logits.argmax(-1, keepdim=True)
        pos = pos + 1
        out.append(tok)
    return torch.cat(out, dim=1).tolist()


# ---------------------------------------------------------------------------
# Convenience: a random batch for smoke runs
# ---------------------------------------------------------------------------


def dummy_batch(gen: torch.Generator, cfg: ModelConfig, batch: int, seq: int,
                kind: str = "train"):
    """A random batch of `kind` ("train", "prefill" or "decode") on the
    generator's device, with the inputs `cfg` takes as the JAX package's
    ``dummy_batch`` gives them: tokens (and labels to train), M-RoPE's
    (3, B, S) positions, a VLM's vision embeddings and an encoder-decoder
    model's ``min(encoder_seq_len, seq)`` audio frames, both in the model's
    dtype (the JAX package draws them in bfloat16 whatever the model's)."""
    dev = gen.device
    s = seq if kind != "decode" else 1
    out = {"tokens": torch.randint(0, cfg.vocab_size, (batch, s),
                                   generator=gen, device=dev)}
    if kind == "train":
        out["labels"] = torch.randint(0, cfg.vocab_size, (batch, seq),
                                      generator=gen, device=dev)
    if cfg.mrope:
        out["positions"] = torch.arange(s, dtype=torch.int32, device=dev
                                        ).expand(3, batch, s)
    dt = L.torch_dtype(cfg.dtype)
    if cfg.vision_tokens and kind != "decode":
        out["vision_embeds"] = torch.randn(
            (batch, min(cfg.vision_tokens, seq // 2), cfg.d_model),
            generator=gen, device=dev).to(dt)
    if cfg.enc_dec and kind != "decode":
        out["audio_frames"] = torch.randn(
            (batch, min(cfg.encoder_seq_len, seq), cfg.d_model),
            generator=gen, device=dev).to(dt)
    return out
