"""The card's peaks and the work a request needs, reckoned from the
configuration's published sizes and the requests' own lengths.

Nothing here looks at what an implementation launches: a prompt counts at
its own length (not its padded bucket), a decode step at the positions each
request really holds, a mixture-of-experts layer at the experts a token is
routed to (shared experts and top-k). So a change that stops padding,
fuses kernels or skips experts is measured against the same work.

Peaks of one NVIDIA H100 SXM (data sheet, dense, at the 700 W limit).
"""
from __future__ import annotations

import dataclasses

PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 494.7e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


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


def causal_pairs(length: int) -> int:
    return length * (length + 1) // 2


def prefill_flops(s: Shape, length: int) -> int:
    """A prompt of `length` tokens: the body for every token, causal
    attention over the prompt itself, and the head for its last row (the
    only logits a server needs from a prefill)."""
    return (2 * s.body_params * length + s.attn_flops(causal_pairs(length))
            + 2 * s.head_params)


def decode_flops(s: Shape, keys: int) -> int:
    """One decoded token that attends `keys` positions (itself included)."""
    return 2 * s.body_params + 2 * s.head_params + s.attn_flops(keys)


def flash_work(s: Shape, length: int) -> tuple[int, int]:
    """(operations, bytes) of causal attention over one prompt, every layer:
    q, k, v read once, the output written once."""
    el = BYTES[s.dtype]
    flops = s.attn_flops(causal_pairs(length))
    nbytes = s.layers * length * (2 * s.hq + 2 * s.hkv) * s.hd * el
    return flops, nbytes


def decode_work(s: Shape, keys: list) -> tuple[int, int]:
    """(operations, bytes) of one decode step's attention, every layer, for
    requests holding `keys` positions each: each request's valid keys and
    values read once, its query read and its output written once."""
    el = BYTES[s.dtype]
    total = sum(keys)
    flops = s.attn_flops(total)
    nbytes = s.layers * el * s.hd * (2 * s.hkv * total
                                      + 2 * s.hq * len(keys))
    return flops, nbytes


def bound_s(flops: float, nbytes: float, dtype: str = "bfloat16") -> float:
    """The least time the card could take: the larger of operations over
    the tensor cores' peak and bytes over the memory's rate."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)
