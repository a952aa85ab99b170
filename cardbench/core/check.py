"""How ``correct`` is decided: the served tokens against the plain reference.

Once the window has closed a sample of the finished requests is drawn from
the run's seed, with the two longest in it (the most served tokens; the
longest prompt and answer together), until it holds ``sample_tokens``
served tokens. The reference runs once over each prompt with its served
tokens and gives the logits at every position that produced one. A served
token is judged by how far its reference logit lies below the reference's
best there; ``max_logit_gap`` is the widest such gap over the sample, and
the run is correct when it is under the cell's limit, no finished request
holds a number of tokens other than it asked for, and the sample compares
at least ``min_tokens`` tokens.

The control (``gap_of_argmax``) puts the fp8 reference in the program's
place: at the same positions, the gap of the token it ranks first.
"""
from __future__ import annotations

import numpy as np
import torch

from cardbench.core import reference


def sample(done: list, seed: int, tokens: int) -> list:
    """Finished requests drawn from `seed`: the one with the most served
    tokens, the longest, then others at random until `tokens` served."""
    if not done:
        return []
    by_out = max(done, key=lambda r: (len(r.tokens), len(r.prompt)))
    by_len = max(done, key=lambda r: (len(r.prompt) + len(r.tokens)))
    pick = [by_out] + ([by_len] if by_len is not by_out else [])
    n = sum(len(r.tokens) for r in pick)
    rest = [r for r in done if r is not by_out and r is not by_len]
    for j in np.random.default_rng([seed, 11]).permutation(len(rest)):
        if n >= tokens:
            break
        pick.append(rest[j])
        n += len(rest[j].tokens)
    return pick


def reference_logits(weights, cfg, pairs, device, precision="f32"):
    """Logits of each (prompt, served tokens) pair at the positions that
    produced the served tokens: (n_served, V) float32 each."""
    seqs = [torch.tensor(p + t[:-1], dtype=torch.long, device=device)
            for p, t in pairs]
    rows = [(len(p) - 1, len(t)) for p, t in pairs]
    return reference.logits(weights, cfg, seqs, rows, precision)


def gaps(ref: list, pairs: list) -> np.ndarray:
    """Each served token's gap below the reference's best logit."""
    out = []
    for lg, (_, toks) in zip(ref, pairs, strict=True):
        t = torch.tensor(toks, device=lg.device)
        best = lg.max(dim=-1).values
        out.append((best - lg.gather(1, t[:, None])[:, 0]).cpu())
    return torch.cat(out).numpy() if out else np.zeros(0)


def gap_of_argmax(ref: list, other: list) -> np.ndarray:
    """The control's reading: at each position, the gap below the
    reference's best of the token `other` ranks first."""
    out = []
    for lg, lo in zip(ref, other, strict=True):
        pick = lo.argmax(dim=-1)
        out.append((lg.max(dim=-1).values
                    - lg.gather(1, pick[:, None])[:, 0]).cpu())
    return torch.cat(out).numpy() if out else np.zeros(0)


def judge(checks: dict) -> bool:
    """Every number within its limit (``min`` checks from below)."""
    return all((c["value"] >= c["limit"]) if c.get("min")
               else (c["value"] <= c["limit"]) for c in checks.values())
