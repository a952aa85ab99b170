"""The one traffic generator. A mix is a data file of parameters
(``cardbench/traffic/<name>.json``); this module turns it into requests.

The draws are a frozen copy of the paper's service mix as the port's
``cluster/workload.py::generate_workload`` makes it (§4.2): Poisson gaps,
then lognormal prompt and output lengths clipped to a range, then
deadlines U[2, 6] s, in that order from one ``numpy`` generator, so that a
mix with the paper's parameters gives the same lengths and deadlines at the
same seed.

Every run seed gets the same work: the sizes, the arrival times and their
order come from the mix's own ``pool_seed``; the run's seed draws the
prompts' token ids (and, elsewhere, the weights and the sample the check
compares). With the order drawn from the run's seed instead, three 45 s
runs of DeepSeekMoE-16B under the docqa mix on an H100 read a
95th-percentile time to first token of 847 to 1160 ms over the same 122
requests.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


def _lengths(rng, spec: dict, n: int) -> np.ndarray:
    mu, sigma = spec["lognormal"]
    lo, hi = spec["clip"]
    return np.clip(rng.lognormal(mu, sigma, n), lo, hi).astype(int)


def draw_pool(mix: dict, n: int, seed: int, rate: float) -> dict:
    """`n` requests of `mix` at `seed`: arrival times (s, Poisson at
    `rate`), prompt and output lengths and deadlines (s)."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=n)
    prompt = _lengths(rng, mix["prompt_tokens"], n)
    out = _lengths(rng, mix["output_tokens"], n)
    lo, hi = mix["deadline_s"]["uniform"]
    deadline = rng.uniform(lo, hi, n)
    return {"arrival": np.cumsum(gaps), "prompt": prompt, "output": out,
            "deadline": deadline}


@dataclasses.dataclass
class Item:
    """One request as the traffic defines it."""
    idx: int
    prompt_len: int
    max_new: int
    deadline: float
    client: int = -1
    offset: float = math.nan      # open loop: due time after the start (s)


def prompt_ids(seed: int, item: Item, vocab: int) -> list:
    """The prompt's token ids, drawn from the run's seed and the item alone,
    so they do not depend on the order the run reaches it."""
    rng = np.random.default_rng([seed, 7, item.idx])
    return rng.integers(0, vocab, item.prompt_len).tolist()


def warm_lengths(mix: dict) -> list:
    """Prompt lengths whose power-of-two buckets cover the mix's range, one
    a bucket, each at most the longest prompt."""
    lo, hi = mix["prompt_tokens"]["clip"]
    out, b = [], 1 << max(lo - 1, 1).bit_length()
    while True:
        out.append(min(b, hi))
        if b >= hi:
            return out
        b <<= 1


def closed_lists(mix: dict) -> list:
    """The closed loop's requests: one list a client, in the order the
    client sends them, the pool dealt round-robin into the lists."""
    n, clients = mix["pool_size"], mix["clients"]
    pool = draw_pool(mix, n, mix["pool_seed"], mix["nominal_rate_per_s"])
    lists = [[] for _ in range(clients)]
    for i in range(n):
        lists[i % clients].append(Item(
            idx=i, prompt_len=int(pool["prompt"][i]),
            max_new=int(pool["output"][i]),
            deadline=float(pool["deadline"][i]), client=i % clients))
    return lists


def open_schedule(mix: dict, rate: float, seconds: float) -> list:
    """The open loop's requests in due order, Poisson at `rate` from the
    mix's pool seed, covering the lead-in, `seconds` of window and the
    tail."""
    span = mix["lead_in_s"] + seconds + mix["tail_s"] + 2.0
    n = int(rate * span * 1.5) + 64
    pool = draw_pool(mix, n, mix["pool_seed"], rate)
    n = int(np.searchsorted(pool["arrival"], span))
    return [Item(idx=i, prompt_len=int(pool["prompt"][i]),
                 max_new=int(pool["output"][i]),
                 deadline=float(pool["deadline"][i]),
                 offset=float(pool["arrival"][i]))
            for i in range(n)]
