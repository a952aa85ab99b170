"""The card's peaks and the work a request needs, reckoned from the
configuration's published sizes and the requests' own lengths.

Nothing here looks at what an implementation launches: a prompt counts at
its own length (not its padded bucket), a decode step at the positions each
request really holds, a mixture-of-experts layer at the experts a token is
routed to (shared experts and top-k). So a change that stops padding,
fuses kernels or skips experts is measured against the same work.

What a block holds (its parameters, its attention's operations and bytes,
its cache a position) is its family's shape (``families/__init__.py``);
the functions here take any family's shape.

Peaks of one NVIDIA H100 SXM (data sheet, dense, at the 700 W limit).
"""
from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 494.7e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def causal_pairs(length: int) -> int:
    return length * (length + 1) // 2


def prefill_flops(s, length: int) -> int:
    """A prompt of `length` tokens: the body for every token, causal
    attention over the prompt itself, and the head for its last row (the
    only logits a server needs from a prefill)."""
    return (2 * s.body_params * length + s.attn_flops(causal_pairs(length))
            + 2 * s.head_params)


def decode_flops(s, keys: int) -> int:
    """One decoded token that attends `keys` positions (itself included)."""
    return 2 * s.body_params + 2 * s.head_params + s.attn_flops(keys)


def flash_work(s, length: int) -> tuple[int, int]:
    """(operations, bytes) of causal attention over one prompt, every layer
    (the shape's ``flash_work``)."""
    return s.flash_work(length)


def decode_work(s, keys: list) -> tuple[int, int]:
    """(operations, bytes) of one decode step's attention, every layer, for
    requests holding `keys` positions each (the shape's ``decode_work``)."""
    return s.decode_work(keys)


def bound_s(flops: float, nbytes: float, dtype: str = "bfloat16") -> float:
    """The least time the card could take: the larger of operations over
    the tensor cores' peak and bytes over the memory's rate."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)
