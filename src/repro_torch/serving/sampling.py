"""Token sampling: greedy / temperature / top-k."""
from __future__ import annotations

from typing import Optional

import torch


def sample_tokens(logits, temperature: float = 0.0, top_k: int = 0,
                  generator: Optional[torch.Generator] = None):
    """logits: (B, V) -> (B,) int32. Greedy when temperature <= 0; else a
    draw from `generator` (seeded by the caller)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / temperature
    if top_k > 0:
        cutoff = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)
