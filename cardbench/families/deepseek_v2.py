"""The ``deepseek_v2`` family (DeepSeek-V2-Lite's ``config.json``): pre-norm
residual blocks of multi-head latent attention (MLA) without q-LoRA, the
first ``first_k_dense_replace`` layers with a dense SwiGLU MLP and the rest
mixtures of experts (a softmax router over routed experts and the shared
experts, ``_decoder.py``'s), a final RMSNorm and an untied head.

The reference, per layer, expanded per head (not the absorbed form the
port decodes with): ``q = h Wq`` split into ``nope`` and ``rope`` columns a
head; ``[c, k_pe] = h Wkv_a``, ``c`` RMS-normed with eps 1e-6 (the published
``kv_a_layernorm``'s default), ``[k_nope, v] = c Wkv_b`` a head; the shared
``k_pe`` rotated once for every head. The rope is YaRN (the file's
``rope_scaling``): blended inverse frequencies, cos and sin times
``mscale(f, mscale) / mscale(f, mscale_all_dim)``, the softmax scale
``(nope + rope)^-1/2 * mscale(f, mscale_all_dim)^2``. It rotates the split
halves of the rope columns, as the port does; the published checkpoint
rotates interleaved pairs, which is the same rotation after a fixed
permutation of those columns of ``Wq`` and ``Wkv_a``: with drawn weights,
the same model. The MoE layer's gates are the top-k softmax probabilities,
renormalised only where ``norm_topk_prob``; the published
``routed_scaling_factor`` is 1, and `port_config` refuses another value.

The port takes the published gate rule and rope scaling as one settings
object, ``ServingEngine(block=repro_torch.models.block.Block(...))``; a
port without it is refused by `port_config` and `engine_args` with
``ValueError``.
"""

import dataclasses
import inspect
import math

import torch

from cardbench.core.reference import Math, exact_float32, mlp, rmsnorm
from cardbench.core.work import BYTES, causal_pairs
from cardbench.families import _decoder

__all__ = ["shape", "logits", "port_config", "engine_args", "small"]

KV_NORM_EPS = 1e-6       # the published kv_a_layernorm's default eps


@dataclasses.dataclass(frozen=True)
class Shape:
    """The sizes the arithmetic needs, from a configuration file."""
    layers: int
    dense_layers: int
    d: int
    heads: int
    nope: int                 # qk_nope_head_dim
    rope: int                 # qk_rope_head_dim
    v: int                    # v_head_dim
    rank: int                 # kv_lora_rank
    ff: int                   # the dense MLP's hidden size
    vocab: int
    experts: int
    top_k: int
    moe_ff: int
    shared: int
    dtype: str = "bfloat16"

    @classmethod
    def of(cls, cfg: dict) -> "Shape":
        if cfg.get("q_lora_rank"):
            raise ValueError("the deepseek_v2 family holds MLA without "
                             "q-LoRA (q_lora_rank null)")
        return cls(
            layers=cfg["num_hidden_layers"],
            dense_layers=cfg["first_k_dense_replace"],
            d=cfg["hidden_size"], heads=cfg["num_attention_heads"],
            nope=cfg["qk_nope_head_dim"], rope=cfg["qk_rope_head_dim"],
            v=cfg["v_head_dim"], rank=cfg["kv_lora_rank"],
            ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
            experts=cfg["n_routed_experts"],
            top_k=cfg["num_experts_per_tok"],
            moe_ff=cfg["moe_intermediate_size"],
            shared=cfg["n_shared_experts"],
            dtype=cfg.get("torch_dtype", "bfloat16"))

    @property
    def qk(self) -> int:
        return self.nope + self.rope

    @property
    def attn_params(self) -> int:
        """``Wq``, ``Wkv_a``, ``Wkv_b`` and ``Wo`` of one layer."""
        h = self.heads
        return (self.d * h * self.qk + self.d * (self.rank + self.rope)
                + self.rank * h * (self.nope + self.v) + h * self.v * self.d)

    @property
    def body_params(self) -> int:
        """Matrix parameters a token passes through below the head: every
        layer's attention projections, the dense MLPs, and per MoE layer
        the router, the shared experts and its top-k routed experts."""
        moe = (self.d * self.experts
               + 3 * self.d * self.moe_ff * (self.shared + self.top_k))
        return (self.layers * self.attn_params
                + self.dense_layers * 3 * self.d * self.ff
                + (self.layers - self.dense_layers) * moe)

    @property
    def head_params(self) -> int:
        return self.vocab * self.d

    def attn_flops(self, keys: int) -> int:
        """Scores over the qk columns and weighted values over the v
        columns, one query over `keys` positions, every layer."""
        return 2 * self.layers * self.heads * (self.qk + self.v) * keys

    def flash_work(self, length: int) -> tuple[int, int]:
        """(operations, bytes) of causal attention over one prompt, every
        layer, at the model's own widths (q and k of qk columns, v and the
        output of v columns, each read or written once)."""
        el = BYTES[self.dtype]
        flops = self.attn_flops(causal_pairs(length))
        nbytes = self.layers * length * self.heads \
            * (2 * self.qk + 2 * self.v) * el
        return flops, nbytes

    def decode_work(self, keys: list) -> tuple[int, int]:
        """(operations, bytes) of one decode step's attention, every layer,
        for requests holding `keys` positions each: each request's valid
        latent positions (rank + rope values) read once, its query read
        and its output written once."""
        el = BYTES[self.dtype]
        total = sum(keys)
        flops = self.attn_flops(total)
        nbytes = self.layers * el * ((self.rank + self.rope) * total
                                     + self.heads * (self.qk + self.v)
                                     * len(keys))
        return flops, nbytes

    @property
    def kv_bytes_per_token(self) -> int:
        """The latent one position holds, every layer."""
        return self.layers * (self.rank + self.rope) * BYTES[self.dtype]

    def layout(self) -> list:
        """(path, shape, std, dtype) of every leaf, in tree order."""
        dt, d, h = self.dtype, self.d, self.heads
        out = [(("embed",), (self.vocab, d), 0.02, dt)]
        for i in range(self.layers):
            p = ("layers", i)
            m = p + ("mix",)
            out += [(p + ("norm1", "scale"), (d,), 0.1, "float32"),
                    (m + ("wq",), (d, h * self.qk), d ** -0.5, dt),
                    (m + ("wkv_a",), (d, self.rank + self.rope), d ** -0.5,
                     dt),
                    (m + ("wkv_b",), (self.rank, h * (self.nope + self.v)),
                     self.rank ** -0.5, dt),
                    (m + ("wo",), (h * self.v, d), (h * self.v) ** -0.5, dt),
                    (m + ("kv_norm", "scale"), (self.rank,), 0.1, "float32"),
                    (p + ("norm2", "scale"), (d,), 0.1, "float32")]
            if i < self.dense_layers:
                out += _decoder._mlp(p + ("mlp",), d, self.ff, dt)
            else:
                e, f = self.experts, self.moe_ff
                q = p + ("moe",)
                out += [(q + ("router",), (d, e), 0.02, "float32"),
                        (q + ("we_gate",), (e, d, f), d ** -0.5, dt),
                        (q + ("we_up",), (e, d, f), d ** -0.5, dt),
                        (q + ("we_down",), (e, f, d), f ** -0.5, dt)]
                out += _decoder._mlp(q + ("shared",), d, self.shared * f, dt)
        out.append((("final_norm", "scale"), (d,), 0.1, "float32"))
        out.append((("unembed",), (self.vocab, d), d ** -0.5, dt))
        return out


def shape(cfg: dict) -> Shape:
    return Shape.of(cfg)


def yarn_mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def yarn_inv_freq(rs: dict, dim: int, base: float) -> torch.Tensor:
    """The published ``DeepseekV2YarnRotaryEmbedding``'s inverse
    frequencies: ``inter * (1 - m) + extra * m``, ``m = 1 - clamp((i - low)
    / (high - low), 0, 1)``, low and high the slots whose wavelengths fit
    ``beta_fast`` and ``beta_slow`` times into the original context."""
    orig = rs["original_max_position_embeddings"]

    def slot(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) \
            / (2 * math.log(base))
    low = max(math.floor(slot(rs["beta_fast"])), 0)
    high = min(math.ceil(slot(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    exps = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    extra = 1.0 / base ** exps
    inter = 1.0 / (rs["factor"] * base ** exps)
    m = 1.0 - ((torch.arange(dim // 2, dtype=torch.float32) - low)
               / (high - low)).clamp(0, 1)
    return inter * (1 - m) + extra * m


def _rope(x, inv_freq, scale):
    """x (S, H, d) at positions 0..S-1, rotated on its split halves."""
    ang = torch.arange(x.shape[0], dtype=torch.float32,
                       device=x.device)[:, None] * inv_freq
    cos, sin = torch.cos(ang)[:, None] * scale, torch.sin(ang)[:, None] * scale
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(h, w, s: Shape, rope: tuple, sm_scale: float, m: Math):
    n, nh = h.shape[0], s.heads
    inv, cs = rope
    q = m.mm(h, w["wq"]).view(n, nh, s.qk)
    c, k_pe = m.mm(h, w["wkv_a"]).split([s.rank, s.rope], dim=-1)
    c = rmsnorm(c, w["kv_norm"]["scale"], KV_NORM_EPS)
    k_nope, v = m.mm(c, w["wkv_b"]).view(n, nh, s.nope + s.v).split(
        [s.nope, s.v], dim=-1)
    q = torch.cat([q[..., :s.nope], _rope(q[..., s.nope:], inv, cs)], dim=-1)
    k_pe = _rope(k_pe[:, None, :], inv, cs).expand(n, nh, s.rope)
    k = torch.cat([k_nope, k_pe], dim=-1).transpose(0, 1)     # (H, S, qk)
    v = v.transpose(0, 1)
    q = q.transpose(0, 1) * sm_scale
    out = torch.empty(nh, n, s.v, device=h.device)
    for a in range(0, n, _decoder.Q_ROWS):
        b = min(a + _decoder.Q_ROWS, n)
        sc = q[:, a:b] @ k[:, :b].transpose(1, 2)
        mask = torch.arange(b, device=h.device)[None, :] \
            > torch.arange(a, b, device=h.device)[:, None]
        sc = sc.masked_fill(mask, float("-inf"))
        out[:, a:b] = torch.softmax(sc, dim=-1) @ v[:, :b]
    return m.mm(out.transpose(0, 1).reshape(n, nh * s.v), w["wo"])


def moe(h, w, s: Shape, cfg: dict, m: Math):
    """``_decoder.moe``'s routed experts plus the shared experts."""
    routed = {k: w[k] for k in ("router", "we_gate", "we_up", "we_down")}
    out = _decoder.moe(h, routed, s, bool(cfg["norm_topk_prob"]), m)
    return out + mlp(h, w["shared"], m)


def logits(weights: dict, cfg: dict, seqs: list, rows: list,
           precision: str = "f32") -> list:
    """For each token sequence in `seqs` (1-D integer tensors on the
    weights' device) the float32 logits of the positions ``rows[i] =
    (start, n)``: (n, V) each. One layer's weights are upcast at a time and
    every sequence passes through it."""
    s = Shape.of(cfg)
    m = Math(precision)
    eps = cfg["rms_norm_eps"]
    rs = cfg["rope_scaling"]
    dev = weights["embed"].device
    rope = (yarn_inv_freq(rs, s.rope, float(cfg["rope_theta"])).to(dev),
            yarn_mscale(rs["factor"], rs["mscale"])
            / yarn_mscale(rs["factor"], rs["mscale_all_dim"]))
    sm_scale = s.qk ** -0.5 * yarn_mscale(rs["factor"],
                                          rs["mscale_all_dim"]) ** 2
    lens = [len(t) for t in seqs]
    with exact_float32(), torch.no_grad():
        xs = [weights["embed"][t].float() for t in seqs]
        for lw_raw in weights["layers"]:
            lw = _decoder._layer_weights(lw_raw, m)
            x = torch.cat([x + attention(rmsnorm(x, lw["norm1"]["scale"],
                                                 eps), lw["mix"], s, rope,
                                         sm_scale, m)
                           for x in xs])
            h = rmsnorm(x, lw["norm2"]["scale"], eps)
            x = x + (moe(h, lw["moe"], s, cfg, m) if "moe" in lw
                     else mlp(h, lw["mlp"], m))
            xs = list(x.split(lens))
            del lw, x, h
        head = m.weight(weights["unembed"].t())
        out = []
        for x, (a, n) in zip(xs, rows, strict=True):
            h = rmsnorm(x[a:a + n], weights["final_norm"]["scale"], eps)
            out.append(m.mm(h, head))
        return out


def _port_block():
    """The port's settings object, or `ValueError` where the port has
    none."""
    from repro_torch.serving.engine import ServingEngine
    if "block" not in inspect.signature(ServingEngine).parameters:
        raise ValueError(
            "the port's ServingEngine takes no published block settings "
            "(block=): it has no setting for the configuration's gate rule "
            "(norm_topk_prob false) or its YaRN rope")
    from repro_torch.models import block
    return block


def port_config(cfg: dict):
    """The port's ``ModelConfig``: MLA with ``q_lora_rank`` 0 (the port's
    spelling of the published null), the dense layer's ``d_ff``, the
    experts' ``moe_d_ff``. A setting the port cannot express is
    refused."""
    _port_block()
    from repro_torch.configs.base import MLAConfig, ModelConfig
    s = Shape.of(cfg)
    fixed = {"first_k_dense_replace": 1, "moe_layer_freq": 1,
             "scoring_func": "softmax", "topk_method": "greedy",
             "n_group": 1, "topk_group": 1, "hidden_act": "silu",
             "tie_word_embeddings": False, "attention_bias": False,
             "routed_scaling_factor": 1}
    for key, want in fixed.items():
        if cfg[key] != want:
            raise ValueError(f"the port runs {key} {want!r} only, the file "
                             f"has {cfg[key]!r}")
    return ModelConfig(
        arch_id=cfg["name"], family="moe", citation=cfg["source"],
        n_layers=s.layers, d_model=s.d, n_heads=s.heads, n_kv_heads=s.heads,
        head_dim=s.nope, d_ff=s.ff, vocab_size=s.vocab, activation="swiglu",
        norm_eps=float(cfg["rms_norm_eps"]), tie_embeddings=False,
        rope_theta=float(cfg["rope_theta"]), n_experts=s.experts,
        n_shared_experts=s.shared, top_k=s.top_k, moe_d_ff=s.moe_ff,
        mla=MLAConfig(q_lora_rank=0, kv_lora_rank=s.rank,
                      qk_nope_head_dim=s.nope, qk_rope_head_dim=s.rope,
                      v_head_dim=s.v),
        dtype=s.dtype)


def engine_args(cfg: dict) -> dict:
    """The published gate rule and YaRN rope as the port's settings
    object."""
    bl = _port_block()
    rs = cfg["rope_scaling"]
    if rs.get("type") != "yarn":
        raise ValueError(f"rope_scaling of type {rs.get('type')!r}: the "
                         f"family runs yarn")
    yarn = bl.YaRN(
        factor=float(rs["factor"]),
        original_max_position_embeddings=int(
            rs["original_max_position_embeddings"]),
        beta_fast=float(rs["beta_fast"]), beta_slow=float(rs["beta_slow"]),
        mscale=float(rs["mscale"]), mscale_all_dim=float(rs["mscale_all_dim"]))
    return {"block": bl.Block(
        norm_topk_prob=bool(cfg["norm_topk_prob"]), rope_scaling=yarn)}


def small(cfg: dict) -> dict:
    """The configuration at the CPU tests' widths: d 64, 3 layers (one
    dense), 4 heads of qk 16 + 8 and v 16 on a latent of 32, vocabulary
    256; 8 routed experts of width 32, top-2, one shared."""
    return dict(cfg, hidden_size=64, intermediate_size=96,
                num_hidden_layers=3, num_attention_heads=4,
                num_key_value_heads=4, vocab_size=256, kv_lora_rank=32,
                qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                moe_intermediate_size=32, n_routed_experts=8,
                num_experts_per_tok=2, n_shared_experts=1)
