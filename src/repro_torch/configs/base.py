"""Architecture config system.

Every assigned architecture (and the paper's own deployment models) is a
``ModelConfig``. The same config object drives:
  * model construction (`repro_torch.models.model.Model`)
  * the dry-run (`repro_torch.launch.dryrun`) via `input_specs()`
  * the scheduler's analytic cost model (`flops_per_token`, `kv_bytes_per_token`)
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Config dataclass
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3 style)."""

    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD (state-space duality) block config."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma / Griffin RG-LRU recurrent block config."""

    d_rnn: int = 0          # lru width (0 -> d_model rounded up)
    d_conv: int = 4
    block_pattern: Tuple[str, ...] = ("rec", "rec", "attn")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity ------------------------------------------------------------
    arch_id: str = "unnamed"
    family: str = "dense"          # dense | moe | ssm | vlm | hybrid | audio
    citation: str = ""

    # transformer core ------------------------------------------------------
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0              # 0 -> d_model // n_heads
    d_ff: int = 1024
    vocab_size: int = 32000
    activation: str = "swiglu"     # swiglu | geglu
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    # positional ------------------------------------------------------------
    rope_theta: float = 10_000.0
    mrope: bool = False            # Qwen2-VL multimodal 3D RoPE

    # attention pattern -------------------------------------------------------
    sliding_window: int = 0            # 0 -> full attention
    local_global_pattern: Tuple[int, int] = (0, 0)   # (n_local, n_global) per block, e.g. (5, 1)

    # MoE ---------------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0              # per-expert hidden (0 -> d_ff)

    # SSM / hybrid --------------------------------------------------------------
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None

    # MLA ------------------------------------------------------------------------
    mla: Optional[MLAConfig] = None

    # encoder-decoder (audio) -----------------------------------------------------
    enc_dec: bool = False
    n_encoder_layers: int = 0
    encoder_seq_len: int = 1500    # whisper: 30s of audio -> 1500 frames

    # vlm stub ---------------------------------------------------------------------
    vision_tokens: int = 0         # number of stub patch embeddings in inputs

    # numerics
    dtype: str = "bfloat16"

    # ------------------------------------------------------------------ helpers
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """True when a 500k-token decode cache is sub-quadratic / windowed."""
        if self.family in ("ssm", "hybrid"):
            return True
        if self.sliding_window > 0:
            return True
        if self.local_global_pattern != (0, 0):
            return True
        return False

    @property
    def has_decode(self) -> bool:
        return True  # all assigned archs are decoder-bearing (whisper is enc-dec)

    # -------------------------------------------------------------- cost model
    def param_count(self) -> int:
        """Total parameter count (all experts)."""
        return _param_count(self, active_only=False)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: shared + top-k experts)."""
        return _param_count(self, active_only=True)

    def flops_per_token(self) -> float:
        """Forward FLOPs per generated/processed token, ~2 * active params."""
        return 2.0 * self.active_param_count()

    def train_flops_per_token(self) -> float:
        return 6.0 * self.active_param_count()

    def kv_bytes_per_token(self, bytes_per_elem: int = 2) -> float:
        """Per-token decode-state bytes (amortized over layers)."""
        if self.family == "ssm":
            return 0.0  # O(1) state, no per-token growth
        hd = self.resolved_head_dim
        per_layer = (self.mla.kv_lora_rank + self.mla.qk_rope_head_dim
                     if self.mla is not None else 2 * self.n_kv_heads * hd)
        n_attn = self.attention_layer_count()
        return float(n_attn * per_layer * bytes_per_elem)

    def attention_layer_count(self) -> int:
        if self.family == "ssm":
            return 0
        if self.rglru is not None:
            pat = self.rglru.block_pattern
            n_attn_per = sum(1 for b in pat if b == "attn")
            full_blocks = self.n_layers // len(pat)
            tail = self.n_layers % len(pat)
            return full_blocks * n_attn_per + sum(
                1 for b in pat[:tail] if b == "attn")
        return self.n_layers

    def param_bytes(self, bytes_per_elem: int = 2) -> float:
        return float(self.param_count() * bytes_per_elem)

    def reduced(self, n_layers: int = 2, d_model: int = 256,
                vocab_size: int = 1024) -> "ModelConfig":
        """A tiny same-family variant for CPU smoke tests."""
        hd = 64
        n_heads = max(2, d_model // hd)
        # keep the q:kv ratio of the full config
        ratio = max(1, self.n_heads // max(1, self.n_kv_heads))
        n_kv = max(1, n_heads // ratio)
        kw = dict(
            arch_id=self.arch_id + "-smoke",
            n_layers=n_layers,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=hd,
            d_ff=4 * d_model if self.family != "moe" else 2 * d_model,
            vocab_size=vocab_size,
            encoder_seq_len=32,
        )
        if self.n_experts:
            kw.update(n_experts=min(4, self.n_experts),
                      top_k=min(2, self.top_k),
                      n_shared_experts=min(1, self.n_shared_experts),
                      moe_d_ff=d_model)
        if self.ssm is not None:
            kw.update(ssm=SSMConfig(d_state=16, head_dim=32, chunk_size=16))
        if self.rglru is not None:
            kw.update(rglru=RGLRUConfig(d_rnn=d_model,
                                        block_pattern=self.rglru.block_pattern),
                      n_layers=max(n_layers, len(self.rglru.block_pattern)))
        if self.mla is not None:
            kw.update(mla=MLAConfig(q_lora_rank=128, kv_lora_rank=64,
                                    qk_nope_head_dim=32, qk_rope_head_dim=16,
                                    v_head_dim=32))
        if self.sliding_window:
            kw.update(sliding_window=64)
        if self.local_global_pattern != (0, 0):
            kw.update(local_global_pattern=self.local_global_pattern,
                      sliding_window=64,
                      n_layers=max(n_layers, sum(self.local_global_pattern)))
        if self.enc_dec:
            kw.update(enc_dec=True, n_encoder_layers=n_layers)
        if self.vision_tokens:
            kw.update(vision_tokens=16, mrope=self.mrope)
        return dataclasses.replace(self, **kw)


def _param_count(cfg: ModelConfig, active_only: bool) -> int:
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    embed = cfg.vocab_size * d
    unembed = 0 if cfg.tie_embeddings else cfg.vocab_size * d

    def attn_params() -> int:
        if cfg.mla is not None:
            m = cfg.mla
            qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
            p = d * m.q_lora_rank + m.q_lora_rank * cfg.n_heads * qk_hd
            p += d * (m.kv_lora_rank + m.qk_rope_head_dim)
            p += m.kv_lora_rank * cfg.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
            p += cfg.n_heads * m.v_head_dim * d
            return p
        q = d * cfg.n_heads * hd
        kv = 2 * d * cfg.n_kv_heads * hd
        o = cfg.n_heads * hd * d
        return q + kv + o

    def mlp_params(hidden: int) -> int:
        return 3 * d * hidden  # gated MLP: up, gate, down

    def moe_layer(active: bool) -> int:
        h = cfg.moe_d_ff or cfg.d_ff
        router = d * cfg.n_experts
        shared = cfg.n_shared_experts * mlp_params(h)
        n_routed = cfg.top_k if active else cfg.n_experts
        return router + shared + n_routed * mlp_params(h)

    total = embed + unembed
    if cfg.family == "ssm":
        s = cfg.ssm
        di = s.d_inner(d)
        nh = s.n_heads(d)
        conv_dim = di + 2 * s.d_state  # x, B, C share the causal conv
        # in_proj emits (z, x, B, C, dt); out_proj folds back; +A, D, norm
        per_layer = (d * (2 * di + 2 * s.d_state + nh) + di * d
                     + s.d_conv * conv_dim + 2 * nh + di)
        total += cfg.n_layers * per_layer
        return total

    if cfg.rglru is not None:
        d_rnn = cfg.rglru.d_rnn or d
        rec_layer = 2 * d * d_rnn + d_rnn * d + 3 * d_rnn + cfg.rglru.d_conv * d_rnn
        attn_layer = attn_params()
        mlp = mlp_params(cfg.d_ff)
        n_attn = cfg.attention_layer_count()
        n_rec = cfg.n_layers - n_attn
        total += n_rec * (rec_layer + mlp) + n_attn * (attn_layer + mlp)
        return total

    per_layer = attn_params()
    if cfg.n_experts:
        per_layer += moe_layer(active_only)
    else:
        per_layer += mlp_params(cfg.d_ff)
    n_dec = cfg.n_layers
    total += n_dec * per_layer
    if cfg.enc_dec:
        # encoder self-attn + mlp, decoder gains cross-attn
        total += cfg.n_encoder_layers * (attn_params() + mlp_params(cfg.d_ff))
        total += n_dec * attn_params()  # cross attention
    return total


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.arch_id] = cfg
    return cfg


def get_config(arch_id: str) -> ModelConfig:
    _ensure_loaded()
    if arch_id not in _REGISTRY:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]


def list_archs() -> list:
    _ensure_loaded()
    return sorted(_REGISTRY)


_LOADED = False


def _ensure_loaded() -> None:
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    # import every config module for its register() side effect
    from repro_torch.configs import (  # noqa: F401
        mixtral_8x7b, minicpm3_4b, deepseek_moe_16b, mamba2_2p7b,
        qwen2_vl_2b, gemma3_12b, recurrentgemma_2b, gemma_2b,
        whisper_base, gemma3_27b, paper_models,
    )


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> bool:
    """Whether (arch, shape) is in scope (long_500k needs sub-quadratic)."""
    if shape.name == "long_500k":
        return cfg.supports_long_context
    return True
