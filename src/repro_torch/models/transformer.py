"""Block-program transformer assembly (dense, MoE, MLA, Mamba-2, RG-LRU
hybrid and M-RoPE families).

An architecture is a *block program*: optional leading ``head`` layers, a
repeating ``superblock`` and an optional ``tail`` (e.g. gemma3's 5 local :
1 global superblock, gemma3-27b's 62 = 10*6 + 2 layers, deepseek-moe's one
dense-MLP head layer before 27 MoE layers, mamba2's single ssm layer 64
times, recurrentgemma's (rec, rec, attn(window)) superblock 8 times and a
(rec, rec) tail). M-RoPE (qwen2-vl) changes only the rotary embedding, not
the program. The JAX package scans stacked superblock parameters; the port
keeps one parameter dict and one cache dict per layer, in execution order,
and runs them in a Python loop. Cache leaves are batch-first: attention (B,
S, Hkv, D) ``k``/``v``, MLA (B, S, kv_lora_rank) ``ckv`` and (B, S,
qk_rope_head_dim) ``krope``, ssm (B, H, P, N) ``state`` and (B, d_conv - 1,
C) ``conv``, rec (B, d_rnn) float32 ``h`` and (B, d_conv - 1, d_rnn)
``conv``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.models import ssm as SSM

NOT_PORTED = ("is not ported yet (ROADMAP.md §1: the encoder-decoder "
              "family)")


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """An attention (``attn``), latent-attention (``mla``), Mamba-2
    (``ssm``) or RG-LRU recurrent (``rec``) layer, with a routed-expert MLP
    where ``moe``; the JAX package's cross-attention layers (``cross``) are
    not ported yet."""
    kind: str = "attn"        # attn | mla | ssm | rec
    window: int = 0           # 0 -> full attention
    moe: bool = False


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
    """The block program of a dense, MoE, MLA, Mamba-2, RG-LRU hybrid or
    M-RoPE model, as the JAX package builds it; an encoder-decoder model
    raises."""
    if cfg.family == "ssm":
        return BlockProgram((), (LayerSpec("ssm"),), cfg.n_layers, ())
    if cfg.enc_dec:
        raise NotImplementedError(f"{cfg.arch_id} ({cfg.family}) {NOT_PORTED}")
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
    spec = LayerSpec(kind, window=cfg.sliding_window, moe=moe)
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
    return L.init_kv_cache(cfg, batch, max_seq, window=spec.window,
                           dtype=dtype, device=device)


def apply_layer(spec: LayerSpec, p, x, *, cfg: ModelConfig, mode: str,
                cache=None, pos=None, positions=None,
                moe_dispatch: str = "dense"):
    """Pre-norm residual block. Returns (x, cache', aux): aux holds the
    MoE layer's ``moe_aux_loss``, and is empty for other layers."""
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    if spec.kind == "ssm":
        mix, new_cache = SSM.ssm_layer(p["mix"], h, cfg=cfg, mode=mode,
                                       cache=cache)
        return x + mix, new_cache, {}
    if spec.kind == "mla":
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
    x = x + mix
    h = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
    aux = {}
    if spec.moe:
        out, aux = MOE.moe_fn(moe_dispatch)(p["moe"], h, cfg=cfg)
    else:
        out = L.mlp(p["mlp"], h, cfg.activation)
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
              pos=None, positions=None, moe_dispatch: str = "dense"):
    """Apply every layer in order. Returns (x, cache', aux): the cache is
    updated in place and returned for prefill and decode; aux holds
    ``moe_aux_loss``, summed over the layers as the JAX package sums it
    (float32 zero for a model without MoE layers)."""
    specs = block_program(cfg).layers()
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, (spec, p) in enumerate(zip(specs, layers, strict=True)):
        c = cache[i] if cache is not None else None
        x, _, aux = apply_layer(spec, p, x, cfg=cfg, mode=mode, cache=c,
                                pos=pos, positions=positions,
                                moe_dispatch=moe_dispatch)
        if "moe_aux_loss" in aux:
            aux_sum = aux_sum + aux["moe_aux_loss"]
    new_cache = cache if cache is not None \
        and mode in ("prefill", "decode") else None
    return x, new_cache, {"moe_aux_loss": aux_sum}
