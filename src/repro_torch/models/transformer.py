"""Block-program transformer assembly (dense, MoE, MLA, Mamba-2, RG-LRU
hybrid, M-RoPE and encoder-decoder families).

An architecture is a *block program*: optional leading ``head`` layers, a
repeating ``superblock`` and an optional ``tail`` (e.g. gemma3's 5 local :
1 global superblock, gemma3-27b's 62 = 10*6 + 2 layers, deepseek-moe's one
dense-MLP head layer before 27 MoE layers, mamba2's single ssm layer 64
times, recurrentgemma's (rec, rec, attn(window)) superblock 8 times and a
(rec, rec) tail, whisper's decoder of attn(full, cross) 6 times). M-RoPE
(qwen2-vl) changes only the rotary embedding, not the program. Whisper's
encoder is a bidirectional attention stack of its own over the audio
frames (`run_encoder`). The JAX package scans stacked superblock
parameters; the port keeps one parameter dict and one cache dict per layer,
in execution order, and runs them in a Python loop. Cache leaves are
batch-first: attention (B, S, Hkv, D) ``k``/``v`` (with a cross layer's
(B, S_enc, Hkv, D) ``cross_k``/``cross_v``), MLA (B, S, kv_lora_rank)
``ckv`` and (B, S, qk_rope_head_dim) ``krope``, ssm (B, H, P, N) ``state``
and (B, d_conv - 1, C) ``conv``, rec (B, d_rnn) float32 ``h`` and (B,
d_conv - 1, d_rnn) ``conv``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.models import ssm as SSM
from repro_torch.obs.spans import model_range


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """An attention (``attn``), latent-attention (``mla``), Mamba-2
    (``ssm``) or RG-LRU recurrent (``rec``) layer, with a routed-expert MLP
    where ``moe`` and a cross-attention sublayer over the encoder's output
    where ``cross``."""
    kind: str = "attn"        # attn | mla | ssm | rec
    window: int = 0           # 0 -> full attention
    moe: bool = False
    cross: bool = False


@dataclasses.dataclass(frozen=True)
class BlockProgram:
    head: Tuple[LayerSpec, ...]
    superblock: Tuple[LayerSpec, ...]
    n_superblocks: int
    tail: Tuple[LayerSpec, ...]

    @property
    def n_layers(self) -> int:
        return (len(self.head) + len(self.superblock) * self.n_superblocks
                + len(self.tail))

    def layers(self) -> List[LayerSpec]:
        """Every layer's spec in execution order."""
        return (list(self.head) + list(self.superblock) * self.n_superblocks
                + list(self.tail))


def block_program(cfg: ModelConfig) -> BlockProgram:
    """The block program of `cfg`'s decoder, as the JAX package builds
    it."""
    if cfg.family == "ssm":
        return BlockProgram((), (LayerSpec("ssm"),), cfg.n_layers, ())
    if cfg.rglru is not None:
        pat = tuple(
            LayerSpec("rec") if kind == "rec"
            else LayerSpec("attn", window=cfg.sliding_window)
            for kind in cfg.rglru.block_pattern)
        n_sb = cfg.n_layers // len(pat)
        return BlockProgram((), pat, n_sb, pat[:cfg.n_layers - n_sb * len(pat)])
    kind = "mla" if cfg.mla is not None else "attn"
    if cfg.local_global_pattern != (0, 0):
        nl, ng = cfg.local_global_pattern
        per = nl + ng
        sb = tuple([LayerSpec(kind, window=cfg.sliding_window)] * nl
                   + [LayerSpec(kind)] * ng)
        n_sb = cfg.n_layers // per
        tail = sb[: cfg.n_layers - n_sb * per]
        return BlockProgram((), sb, n_sb, tail)
    moe = cfg.n_experts > 0
    spec = LayerSpec(kind, window=cfg.sliding_window, moe=moe,
                     cross=cfg.enc_dec)
    if moe and cfg.n_shared_experts:
        # DeepSeekMoE: the first layer keeps a dense MLP
        head = (LayerSpec(kind, window=cfg.sliding_window),)
        return BlockProgram(head, (spec,), cfg.n_layers - 1, ())
    return BlockProgram((), (spec,), cfg.n_layers, ())


# ---------------------------------------------------------------------------
# Per-layer params / cache
# ---------------------------------------------------------------------------


def init_layer(gen, spec: LayerSpec, cfg: ModelConfig, device=None):
    d = cfg.d_model
    if spec.kind == "ssm":
        # a mamba block has no separate MLP sublayer
        return {"norm1": L.init_rmsnorm(d, device),
                "mix": SSM.init_ssm(gen, cfg, device)}
    p = {"norm1": L.init_rmsnorm(d, device)}
    if spec.kind == "attn":
        p["mix"] = L.init_attention(gen, cfg, device)
    elif spec.kind == "mla":
        p["mix"] = L.init_mla(gen, cfg, device)
    elif spec.kind == "rec":
        p["mix"] = RG.init_rglru(gen, cfg, device)
    else:
        raise ValueError(spec.kind)
    if spec.cross:
        p["norm_cross"] = L.init_rmsnorm(d, device)
        p["cross"] = L.init_attention(gen, cfg, device)
    p["norm2"] = L.init_rmsnorm(d, device)
    if spec.moe:
        p["moe"] = MOE.init_moe(gen, cfg, device)
    else:
        p["mlp"] = L.init_mlp(gen, d, cfg.d_ff, L.torch_dtype(cfg.dtype),
                              device)
    return p


def init_layer_cache(spec: LayerSpec, cfg: ModelConfig, batch: int,
                     max_seq: int, dtype=None, device=None):
    if spec.kind == "ssm":
        return SSM.init_ssm_cache(cfg, batch, dtype=dtype, device=device)
    if spec.kind == "mla":
        return L.init_mla_cache(cfg, batch, max_seq, dtype=dtype,
                                device=device)
    if spec.kind == "rec":
        return RG.init_rglru_cache(cfg, batch, dtype=dtype, device=device)
    if spec.kind != "attn":
        raise ValueError(spec.kind)
    c = L.init_kv_cache(cfg, batch, max_seq, window=spec.window, dtype=dtype,
                        device=device)
    if spec.cross:
        # the encoder's keys and values, written by prefill; prefill puts
        # the encoder's own length in place of these encoder_seq_len slots
        ad = L.attn_dims(cfg)
        shape = (batch, cfg.encoder_seq_len, ad.n_kv_heads, ad.head_dim)
        dt = dtype or L.torch_dtype(cfg.dtype)
        c["cross_k"] = torch.zeros(shape, dtype=dt, device=device)
        c["cross_v"] = torch.zeros(shape, dtype=dt, device=device)
    return c


def apply_layer(spec: LayerSpec, p, x, *, cfg: ModelConfig, mode: str,
                cache=None, pos=None, positions=None,
                moe_dispatch: str = "dense", enc_out=None, ctx=None,
                cspec=None):
    """Pre-norm residual block. Returns (x, cache', aux): aux holds the
    MoE layer's ``moe_aux_loss``, and is empty for other layers. A cross
    layer attends to ``enc_out`` (train, prefill) or to its cached
    ``cross_k``/``cross_v`` (decode); prefill replaces those cache entries
    with the encoder's keys and values, at the encoder's own length. Under
    a mesh (``ctx``) the layer runs on this rank's shards, ``cspec`` being
    its cache's specs (None: the cache is held whole)."""
    if ctx is not None and ctx.mesh is not None:
        return _apply_layer_sharded(spec, p, x, cfg=cfg, mode=mode,
                                    cache=cache, pos=pos,
                                    positions=positions, enc_out=enc_out,
                                    ctx=ctx, cspec=cspec)
    # the ranges of the serving engine's traced steps (`model_range`)
    with model_range("model.norm"):
        h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    with model_range("model.attn"):
        if spec.kind == "ssm":
            mix, new_cache = SSM.ssm_layer(p["mix"], h, cfg=cfg, mode=mode,
                                           cache=cache)
        elif spec.kind == "mla":
            mix, new_cache = L.mla_layer(p["mix"], h, cfg=cfg, mode=mode,
                                         cache=cache, pos=pos,
                                         positions=positions)
        elif spec.kind == "rec":
            mix, new_cache = RG.rglru_layer(p["mix"], h, cfg=cfg, mode=mode,
                                            cache=cache)
        else:
            mix, new_cache = L.attention_layer(
                p["mix"], h, cfg=cfg, mode=mode, cache=cache, pos=pos,
                window=spec.window, positions=positions)
    if spec.kind == "ssm":
        return x + mix, new_cache, {}
    x = x + mix
    use_cross = spec.cross and (
        enc_out is not None
        or (mode == "decode" and cache is not None and "cross_k" in cache))
    if use_cross:
        with model_range("model.norm"):
            h = L.rmsnorm(p["norm_cross"], x, cfg.norm_eps)
        enc_cache = None
        if cache is not None and mode == "decode":
            enc_cache = {"k": cache["cross_k"], "v": cache["cross_v"]}
        with model_range("model.attn"):
            mix, cross_kv = L.attention_layer(
                p["cross"], h, cfg=cfg, mode=mode, enc_out=enc_out,
                enc_cache=enc_cache, causal=False)
        x = x + mix
        if new_cache is not None:
            new_cache["cross_k"] = cross_kv["k"]
            new_cache["cross_v"] = cross_kv["v"]
    with model_range("model.norm"):
        h = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
    aux = {}
    with model_range("model.mlp"):
        if spec.moe:
            out, aux = MOE.moe_fn(moe_dispatch)(p["moe"], h, cfg=cfg)
        else:
            out = L.mlp(p["mlp"], h, cfg.activation)
    return x + out, new_cache, aux


def _apply_layer_sharded(spec: LayerSpec, p, x, *, cfg: ModelConfig,
                         mode: str, cache, pos, positions, enc_out, ctx,
                         cspec):
    """`apply_layer` on local shards (`models/tp.py`). A Mamba-2, RG-LRU or
    MLA mixer runs on the rank's heads or channels (`tp.mixer_layer`), or,
    where they do not divide the model axis and the rules left its leaves
    whole, as on one device.

    Under sequence parallelism (``ctx.seq_sharded``) x is this rank's
    slice of the sequence, and so is each sublayer's output (its
    reduce-scatter): the residual adds and the norms run on the slice, the
    JAX package's two `shard_activation` points (after the mixer and after
    the MLP) being where the slice comes back. A cross-attention reads the
    encoder's output whole."""
    from repro_torch.models import tp as TP
    norms = [k for k in ("norm1", "norm_cross", "norm2") if k in p]
    scales = TP.seq_leaves(ctx, *(p[k]["scale"] for k in norms))
    p = dict(p, **{k: {"scale": t} for k, t in zip(norms, scales,
                                                       strict=True)})
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    if spec.kind in ("ssm", "rec", "mla"):
        if TP.mixer_sharded(spec.kind, cfg, ctx):
            mix, new_cache = TP.mixer_layer(
                spec.kind, p["mix"], h, cfg=cfg, ctx=ctx, mode=mode,
                cache=cache, cspec=cspec, pos=pos, positions=positions)
        else:
            def mix_fn(pw, h, cw):
                if spec.kind == "ssm":
                    return SSM.ssm_layer(pw, h, cfg=cfg, mode=mode, cache=cw)
                if spec.kind == "rec":
                    return RG.rglru_layer(pw, h, cfg=cfg, mode=mode,
                                          cache=cw)
                return L.mla_layer(pw, h, cfg=cfg, mode=mode, cache=cw,
                                   pos=pos, positions=positions)
            pspecs = TP.layer_param_specs(cfg, spec, ctx)["mix"]
            mix, new_cache = TP.replicated_layer(mix_fn, p["mix"], h, cache,
                                                 cspec, pspecs, ctx)
        if spec.kind == "ssm":
            return x + mix, new_cache, {}
    else:
        kv_spec = cspec["k"] if cspec is not None else None
        mix, new_cache = L.attention_layer(
            p["mix"], h, cfg=cfg, mode=mode, cache=cache, pos=pos,
            window=spec.window, positions=positions, ctx=ctx, cspec=kv_spec)
    x = x + mix
    use_cross = spec.cross and (
        enc_out is not None
        or (mode == "decode" and cache is not None and "cross_k" in cache))
    if use_cross:
        h = L.rmsnorm(p["norm_cross"], x, cfg.norm_eps)
        cross_spec = cspec["cross_k"] if cspec is not None else None
        enc_cache = None
        if cache is not None and mode == "decode":
            enc_cache = {"k": cache["cross_k"], "v": cache["cross_v"]}
        mix, cross_kv = L.attention_layer(
            p["cross"], h, cfg=cfg, mode=mode, enc_out=enc_out,
            enc_cache=enc_cache, causal=False, ctx=ctx, cspec=cross_spec)
        x = x + mix
        if new_cache is not None and mode != "decode":
            for key in ("k", "v"):
                new_cache["cross_" + key] = TP.cache_view(
                    cross_kv[key], cache["cross_" + key], cross_spec, ctx)
    h = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
    aux = {}
    if spec.moe:
        out, aux = MOE.moe_fn(ctx.moe_dispatch, ctx)(p["moe"], h, cfg=cfg,
                                                     ctx=ctx)
    else:
        out = L.mlp(p["mlp"], h, cfg.activation, ctx, cfg.d_ff)
    return x + out, new_cache, aux


# ---------------------------------------------------------------------------
# Whole stack
# ---------------------------------------------------------------------------


def init_stack(gen, cfg: ModelConfig, device=None):
    return [init_layer(gen, spec, cfg, device)
            for spec in block_program(cfg).layers()]


def init_stack_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
                     device=None):
    return [init_layer_cache(spec, cfg, batch, max_seq, dtype=dtype,
                             device=device)
            for spec in block_program(cfg).layers()]


def run_stack(layers, x, *, cfg: ModelConfig, mode: str, cache=None,
              pos=None, positions=None, moe_dispatch: str = "dense",
              enc_out=None, remat: bool = False, ctx=None):
    """Apply every layer in order. Returns (x, cache', aux): the cache is
    updated in place and returned for prefill and decode; aux holds
    ``moe_aux_loss``, summed over the layers as the JAX package sums it
    (float32 zero for a model without MoE layers). With ``remat`` in train
    mode each layer runs under `torch.utils.checkpoint`, so the backward
    recomputes one layer at a time (the JAX package's nested remat). Under
    a mesh (``ctx``) the layers run on this rank's shards; a cache with
    ``specs`` (`model.init_cache` under a mesh) says how each layer's cache
    is split; with ``ctx.seq_sharded`` x (and so each checkpointed layer
    input) is this rank's slice of the sequence."""
    specs = block_program(cfg).layers()
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    layer_remat = remat and mode == "train"
    cspecs = getattr(cache, "specs", None)
    for i, (spec, p) in enumerate(zip(specs, layers, strict=True)):
        c = cache[i] if cache is not None else None
        kw = dict(cfg=cfg, mode=mode, cache=c, pos=pos, positions=positions,
                  moe_dispatch=moe_dispatch, enc_out=enc_out)
        if ctx is not None and ctx.mesh is not None:
            kw.update(ctx=ctx, cspec=cspecs[i] if cspecs else None)
        if layer_remat:
            x, _, aux = torch.utils.checkpoint.checkpoint(
                apply_layer, spec, p, x, use_reentrant=False, **kw)
        else:
            x, _, aux = apply_layer(spec, p, x, **kw)
        if "moe_aux_loss" in aux:
            aux_sum = aux_sum + aux["moe_aux_loss"]
    new_cache = cache if cache is not None \
        and mode in ("prefill", "decode") else None
    return x, new_cache, {"moe_aux_loss": aux_sum}


# ---------------------------------------------------------------------------
# Whisper encoder (bidirectional stack over stub frame embeddings)
# ---------------------------------------------------------------------------


def init_encoder(gen, cfg: ModelConfig, device=None):
    """One parameter dict per encoder layer (plain attention + MLP) and the
    final norm."""
    spec = LayerSpec("attn")
    return {"layers": [init_layer(gen, spec, cfg, device)
                       for _ in range(cfg.n_encoder_layers)],
            "norm": L.init_rmsnorm(cfg.d_model, device)}


def sinusoidal_positions(seq: int, d: int, device=None):
    """(1, seq, d) float32: sin of the d/2 frequencies, then cos."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(torch.tensor(10000.0, device=device), dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)[None]


def run_encoder(params, frames, *, cfg: ModelConfig, ctx=None):
    """frames: (B, S_enc, D) stub conv-frontend embeddings -> (B, S_enc, D).
    Each layer's attention is bidirectional (the flash kernel with
    ``causal=False`` on the card) and unrotated."""
    x = frames + sinusoidal_positions(frames.shape[1], cfg.d_model,
                                      frames.device).to(frames.dtype)

    for p in params["layers"]:
        h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
        mix, _ = L.attention_layer(p["mix"], h, cfg=cfg, mode="encode",
                                   causal=False, ctx=ctx)
        x = x + mix
        h = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
        x = x + L.mlp(p["mlp"], h, cfg.activation, ctx, cfg.d_ff)
    return L.rmsnorm(params["norm"], x, cfg.norm_eps)
