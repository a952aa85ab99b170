"""The body the ``llama`` and ``deepseek`` families share: a decoder of
pre-norm residual blocks with grouped-query attention and a SwiGLU MLP, or
in a mixture-of-experts layer a softmax router over routed and shared
experts.

The reference: RMSNorm ``x / rms(x) * (1 + scale)``; rotary embedding on
the split halves of each head, angle ``pos * theta^(-2i/D)``; causal
grouped-query attention, query head h reading key/value head ``h // (Hq /
Hkv)``; a SwiGLU MLP ``(silu(x Wg) * x Wu) Wd``; in a mixture-of-experts
layer a float32 softmax router whose top-k gates are renormalised where
``norm_topk_prob`` says so, the routed experts' gated sum and the shared
experts' MLP; a final RMSNorm and an untied head.

The weights: the parameter dict the port's engine takes (``embed``,
``layers`` one dict a layer, ``final_norm``, ``unembed``), matrices stored
(in, out) in the served dtype, norm scales and the router in float32.
"""
from __future__ import annotations

import dataclasses

import torch

from cardbench.core.reference import Math, exact_float32, mlp, rmsnorm, rope
from cardbench.core.work import BYTES, causal_pairs

Q_ROWS = 512             # query rows of one attention block


@dataclasses.dataclass(frozen=True)
class Shape:
    """The sizes the arithmetic needs, from a configuration file."""
    layers: int
    dense_layers: int         # layers with a dense MLP; the rest are MoE
    d: int
    hq: int
    hkv: int
    hd: int
    ff: int                   # the dense MLP's hidden size
    vocab: int
    experts: int = 0
    top_k: int = 0
    moe_ff: int = 0
    shared: int = 0
    dtype: str = "bfloat16"

    @classmethod
    def of(cls, cfg: dict) -> "Shape":
        layers = cfg["num_hidden_layers"]
        experts = cfg.get("n_routed_experts", 0)
        hq = cfg["num_attention_heads"]
        return cls(
            layers=layers,
            dense_layers=cfg.get("first_k_dense_replace", 0) if experts
            else layers,
            d=cfg["hidden_size"], hq=hq, hkv=cfg["num_key_value_heads"],
            hd=cfg.get("head_dim") or cfg["hidden_size"] // hq,
            ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
            experts=experts, top_k=cfg.get("num_experts_per_tok", 0),
            moe_ff=cfg.get("moe_intermediate_size", 0),
            shared=cfg.get("n_shared_experts", 0),
            dtype=cfg.get("torch_dtype", "bfloat16"))

    @property
    def attn_params(self) -> int:
        return (2 * self.d * self.hq * self.hd
                + 2 * self.d * self.hkv * self.hd)

    @property
    def body_params(self) -> int:
        """Matrix parameters a token passes through below the head: every
        layer's attention projections, the dense MLPs, and per MoE layer
        the router, the shared experts and its top-k routed experts."""
        moe_layers = self.layers - self.dense_layers
        moe = (self.d * self.experts
               + 3 * self.d * self.moe_ff * (self.shared + self.top_k))
        return (self.layers * self.attn_params
                + self.dense_layers * 3 * self.d * self.ff
                + moe_layers * moe)

    @property
    def head_params(self) -> int:
        return self.vocab * self.d

    def attn_flops(self, keys: int) -> int:
        """Scores and weighted values of one query over `keys` positions,
        every layer."""
        return 4 * self.layers * self.hq * self.hd * keys

    def flash_work(self, length: int) -> tuple[int, int]:
        """(operations, bytes) of causal attention over one prompt, every
        layer: q, k, v read once, the output written once."""
        el = BYTES[self.dtype]
        flops = self.attn_flops(causal_pairs(length))
        nbytes = self.layers * length * (2 * self.hq + 2 * self.hkv) \
            * self.hd * el
        return flops, nbytes

    def decode_work(self, keys: list) -> tuple[int, int]:
        """(operations, bytes) of one decode step's attention, every layer,
        for requests holding `keys` positions each: each request's valid
        keys and values read once, its query read and its output written
        once."""
        el = BYTES[self.dtype]
        total = sum(keys)
        flops = self.attn_flops(total)
        nbytes = self.layers * el * self.hd * (2 * self.hkv * total
                                               + 2 * self.hq * len(keys))
        return flops, nbytes

    @property
    def kv_bytes_per_token(self) -> int:
        """The keys and values one position holds, every layer."""
        return 2 * self.layers * self.hkv * self.hd * BYTES[self.dtype]

    def layout(self) -> list:
        return layout(self)


def layout(s: Shape) -> list:
    """(path, shape, std, dtype) of every leaf, in tree order."""
    dt = s.dtype
    q, kv = s.hq * s.hd, s.hkv * s.hd
    out = [(("embed",), (s.vocab, s.d), 0.02, dt)]
    for i in range(s.layers):
        p = ("layers", i)
        out += [(p + ("norm1", "scale"), (s.d,), 0.1, "float32"),
                (p + ("mix", "wq"), (s.d, q), s.d ** -0.5, dt),
                (p + ("mix", "wk"), (s.d, kv), s.d ** -0.5, dt),
                (p + ("mix", "wv"), (s.d, kv), s.d ** -0.5, dt),
                (p + ("mix", "wo"), (q, s.d), q ** -0.5, dt),
                (p + ("norm2", "scale"), (s.d,), 0.1, "float32")]
        if i < s.dense_layers:
            out += _mlp(p + ("mlp",), s.d, s.ff, dt)
        else:
            m = p + ("moe",)
            e, f = s.experts, s.moe_ff
            out += [(m + ("router",), (s.d, e), 0.02, "float32"),
                    (m + ("we_gate",), (e, s.d, f), s.d ** -0.5, dt),
                    (m + ("we_up",), (e, s.d, f), s.d ** -0.5, dt),
                    (m + ("we_down",), (e, f, s.d), f ** -0.5, dt)]
            if s.shared:
                out += _mlp(m + ("shared",), s.d, s.shared * f, dt)
    out.append((("final_norm", "scale"), (s.d,), 0.1, "float32"))
    out.append((("unembed",), (s.vocab, s.d), s.d ** -0.5, dt))
    return out


def _mlp(p, d, f, dt):
    return [(p + ("w_gate",), (d, f), d ** -0.5, dt),
            (p + ("w_up",), (d, f), d ** -0.5, dt),
            (p + ("w_down",), (f, d), f ** -0.5, dt)]


def attention(h, w, s: Shape, theta: float, m: Math):
    n = h.shape[0]
    q = rope(m.mm(h, w["wq"]).view(n, s.hq, s.hd), theta)
    k = rope(m.mm(h, w["wk"]).view(n, s.hkv, s.hd), theta)
    v = m.mm(h, w["wv"]).view(n, s.hkv, s.hd)
    g = s.hq // s.hkv
    k = k.repeat_interleave(g, dim=1).transpose(0, 1)     # (H, S, D)
    v = v.repeat_interleave(g, dim=1).transpose(0, 1)
    q = q.transpose(0, 1) * s.hd ** -0.5
    out = torch.empty_like(q)
    for a in range(0, n, Q_ROWS):
        b = min(a + Q_ROWS, n)
        sc = q[:, a:b] @ k[:, :b].transpose(1, 2)          # (H, r, b)
        mask = torch.arange(b, device=h.device)[None, :] \
            > torch.arange(a, b, device=h.device)[:, None]
        sc = sc.masked_fill(mask, float("-inf"))
        out[:, a:b] = torch.softmax(sc, dim=-1) @ v[:, :b]
    out = out.transpose(0, 1).reshape(n, s.hq * s.hd)
    return m.mm(out, w["wo"])


def moe(h, w, s: Shape, renorm: bool, m: Math):
    probs = torch.softmax(h @ w["router"].float(), dim=-1)
    top, idx = torch.topk(probs, s.top_k, dim=-1)
    if renorm:
        top = top / top.sum(-1, keepdim=True)
    out = mlp(h, w["shared"], m) if "shared" in w else torch.zeros_like(h)
    for e in range(s.experts):
        rows, slot = (idx == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        ew = {"w_gate": w["we_gate"][e], "w_up": w["we_up"][e],
              "w_down": w["we_down"][e]}
        y = mlp(h[rows], ew, m)
        out.index_add_(0, rows, y * top[rows, slot][:, None])
    return out


def _layer_weights(lw: dict, m: Math) -> dict:
    out = {}
    for key, val in lw.items():
        if isinstance(val, dict):
            out[key] = _layer_weights(val, m)
        elif key in ("scale", "router"):
            out[key] = val.float()
        else:
            out[key] = m.weight(val)
    return out


def logits(weights: dict, cfg: dict, seqs: list, rows: list,
           precision: str = "f32") -> list:
    """For each token sequence in `seqs` (1-D integer tensors on the
    weights' device) the float32 logits of the positions ``rows[i] =
    (start, n)``: (n, V) each. One layer's weights are upcast at a time and
    every sequence passes through it."""
    s = Shape.of(cfg)
    m = Math(precision)
    eps, theta = cfg["rms_norm_eps"], float(cfg["rope_theta"])
    renorm = bool(cfg.get("norm_topk_prob", False))
    lens = [len(t) for t in seqs]
    with exact_float32(), torch.no_grad():
        xs = [weights["embed"][t].float() for t in seqs]
        for lw_raw in weights["layers"]:
            lw = _layer_weights(lw_raw, m)
            x = torch.cat([x + attention(rmsnorm(x, lw["norm1"]["scale"],
                                                 eps), lw["mix"], s, theta, m)
                           for x in xs])
            # the MLP is token by token: all sequences at once
            h = rmsnorm(x, lw["norm2"]["scale"], eps)
            x = x + (moe(h, lw["moe"], s, renorm, m) if "moe" in lw
                     else mlp(h, lw["mlp"], m))
            xs = list(x.split(lens))
            del lw, x, h
        head = m.weight(weights["unembed"].t())
        out = []
        for x, (a, n) in zip(xs, rows, strict=True):
            h = rmsnorm(x[a:a + n], weights["final_norm"]["scale"], eps)
            out.append(m.mm(h, head))
        return out


def port_config(cfg: dict):
    """The port's ``ModelConfig`` for a configuration file: the registry's
    architecture with the file's published sizes, norm epsilon and rotary
    base put in. A setting the port cannot express is refused."""
    from repro_torch.configs import get_config
    heads = cfg["num_attention_heads"]
    kw = dict(n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
              n_heads=heads, n_kv_heads=cfg["num_key_value_heads"],
              head_dim=cfg.get("head_dim") or cfg["hidden_size"] // heads,
              d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
              norm_eps=float(cfg["rms_norm_eps"]),
              rope_theta=float(cfg["rope_theta"]),
              tie_embeddings=bool(cfg["tie_word_embeddings"]),
              dtype=cfg["torch_dtype"], logit_softcap=0.0, sliding_window=0)
    if cfg.get("n_routed_experts"):
        if cfg.get("first_k_dense_replace") != 1:
            raise ValueError("the port keeps exactly one leading dense layer "
                             "in a model with shared experts")
        kw.update(n_experts=cfg["n_routed_experts"],
                  n_shared_experts=cfg["n_shared_experts"],
                  top_k=cfg["num_experts_per_tok"],
                  moe_d_ff=cfg["moe_intermediate_size"])
    return dataclasses.replace(get_config(cfg["arch"]), **kw)


def small(cfg: dict) -> dict:
    """The configuration at the CPU tests' widths: d 64, 3 layers, 4 query
    heads on 2 key/value heads, vocabulary 256; a mixture of experts with
    8 routed experts of width 32, top-2, one shared."""
    cfg = dict(cfg, hidden_size=64, intermediate_size=96,
               num_hidden_layers=3, num_attention_heads=4,
               num_key_value_heads=2, vocab_size=256)
    if "n_routed_experts" in cfg:
        cfg.update(moe_intermediate_size=32, n_routed_experts=8,
                   num_experts_per_tok=2, n_shared_experts=1)
    return cfg
