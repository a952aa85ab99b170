"""Block-program transformer assembly (dense family).

An architecture is a *block program*: optional leading ``head`` layers, a
repeating ``superblock`` and an optional ``tail`` (e.g. gemma3's 5 local :
1 global superblock, and gemma3-27b's 62 = 10*6 + 2 layers). The JAX package
scans stacked superblock parameters; the port keeps one parameter dict and
one cache dict per layer, in execution order, and runs them in a Python
loop. Cache leaves are batch-first: (B, S, Hkv, D).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

NOT_PORTED = ("is not ported yet (ROADMAP.md §1, queue item 2: the other "
              "model families)")


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """A dense attention layer; the other kinds are not ported yet."""
    window: int = 0           # 0 -> full attention


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
    """The dense family's block program, as the JAX package builds it."""
    if cfg.family == "ssm" or cfg.rglru is not None or cfg.mla is not None \
            or cfg.n_experts > 0 or cfg.enc_dec or cfg.mrope:
        raise NotImplementedError(f"{cfg.arch_id} ({cfg.family}) {NOT_PORTED}")
    if cfg.local_global_pattern != (0, 0):
        nl, ng = cfg.local_global_pattern
        per = nl + ng
        sb = tuple([LayerSpec(window=cfg.sliding_window)] * nl
                   + [LayerSpec()] * ng)
        n_sb = cfg.n_layers // per
        tail = sb[: cfg.n_layers - n_sb * per]
        return BlockProgram((), sb, n_sb, tail)
    spec = LayerSpec(window=cfg.sliding_window)
    return BlockProgram((), (spec,), cfg.n_layers, ())


# ---------------------------------------------------------------------------
# Per-layer params / cache
# ---------------------------------------------------------------------------


def init_layer(gen, cfg: ModelConfig, device=None):
    d = cfg.d_model
    return {
        "norm1": L.init_rmsnorm(d, device),
        "mix": L.init_attention(gen, cfg, device),
        "norm2": L.init_rmsnorm(d, device),
        "mlp": L.init_mlp(gen, d, cfg.d_ff, L.torch_dtype(cfg.dtype), device),
    }


def apply_layer(spec: LayerSpec, p, x, *, cfg: ModelConfig, mode: str,
                cache=None, pos=None, positions=None):
    """Pre-norm residual block. Returns (x, cache')."""
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    mix, new_cache = L.attention_layer(
        p["mix"], h, cfg=cfg, mode=mode, cache=cache, pos=pos,
        window=spec.window, positions=positions)
    x = x + mix
    h = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
    x = x + L.mlp(p["mlp"], h, cfg.activation)
    return x, new_cache


# ---------------------------------------------------------------------------
# Whole stack
# ---------------------------------------------------------------------------


def init_stack(gen, cfg: ModelConfig, device=None):
    return [init_layer(gen, cfg, device) for _ in block_program(cfg).layers()]


def init_stack_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
                     device=None):
    return [L.init_kv_cache(cfg, batch, max_seq, window=spec.window,
                            dtype=dtype, device=device)
            for spec in block_program(cfg).layers()]


def run_stack(layers, x, *, cfg: ModelConfig, mode: str, cache=None,
              pos=None, positions=None):
    """Apply every layer in order. Returns (x, cache'); the cache is
    updated in place and returned for prefill and decode."""
    specs = block_program(cfg).layers()
    for i, (spec, p) in enumerate(zip(specs, layers, strict=True)):
        c = cache[i] if cache is not None else None
        x, _ = apply_layer(spec, p, x, cfg=cfg, mode=mode, cache=c, pos=pos,
                           positions=positions)
    if cache is not None and mode in ("prefill", "decode"):
        return x, cache
    return x, None

