"""Continuous-batching serving engine (dense KV cache).

A fixed pool of `max_batch` KV-cache slots; requests are admitted into free
slots (prefill) and all slots decode together each step with per-slot
positions (the `update_cache_seq` vector-position path). This is the
execution layer a PerLLM "server" runs: the scheduler decides *which*
server a request goes to, the engine decides *how* it runs there.

Prefill attention runs on the flash kernel and every decode step on the
decode kernel when the engine runs on the card. The paged KV cache
(`paged=True` in the JAX package) is not ported yet.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.models.parallel import resolve_device
from repro_torch.obs.metrics import MetricsRegistry, counter_attr, with_aliases
from repro_torch.serving.sampling import sample_tokens

PAGED_NOT_PORTED = ("the paged KV cache is not ported yet (ROADMAP.md §1, "
                    "queue item 1: serving/kvcache.py + the paged engine "
                    "path)")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int = 32
    eos_id: int = -1          # -1: never stop early
    # runtime
    slot: int = -1
    generated: List[int] = dataclasses.field(default_factory=list)
    submitted_at: float = 0.0
    first_token_at: float = -1.0
    done_at: float = -1.0

    @property
    def done(self) -> bool:
        return self.done_at >= 0


class ServingEngine:
    # shape counters kept from the JAX engine, where each new shape is one
    # XLA compile: decode should stay at one (batch, 1) shape, prefill at
    # one per pow-2 prompt bucket (the count a later CUDA-graph cache holds)
    decode_compiles = counter_attr("engine.decode_compiles")
    prefill_compiles = counter_attr("engine.prefill_compiles")

    def __init__(self, cfg: ModelConfig, params, max_batch: int = 8,
                 max_seq: int = 1024, device=None, temperature: float = 0.0,
                 seed: int = 0, paged: bool = False):
        if paged:
            raise NotImplementedError(PAGED_NOT_PORTED)
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params are on {params['embed'].device}, the "
                             f"engine runs on {self.device}")
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.temperature = temperature
        self.cache = M.init_cache(cfg, max_batch, max_seq, device=self.device)
        self.positions = [0] * max_batch
        self.cur_tokens = [0] * max_batch
        self.slot_req: List[Optional[Request]] = [None] * max_batch
        self.queue: List[Request] = []
        self._rid = itertools.count()
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.completed: List[Request] = []
        self.metrics = MetricsRegistry()
        self._compiled_shapes: set = set()
        self.n_prefills = 0
        # prefix sharing needs the paged cache: both stay 0 here, for the
        # fleet's stats
        self.n_prefix_hits = 0
        self.prefix_tokens_reused = 0
        # DVFS pacing hint: the relative clock frequency this engine's host
        # runs at. `step` is frequency-blind; PerLLMServer stretches each
        # tick by 1/freq_scale. Set via `set_freq_scale`.
        self.freq_scale = 1.0
        # the fleet asks every engine whether it is paged (and for its pool)
        self.paged = False
        self.kv = None

    # ------------------------------------------------------------------
    def submit(self, prompt: List[int], max_new_tokens: int = 32,
               eos_id: int = -1) -> Request:
        req = Request(rid=next(self._rid), prompt=list(prompt),
                      max_new_tokens=max_new_tokens, eos_id=eos_id,
                      submitted_at=time.time())
        self.queue.append(req)
        return req

    def set_freq_scale(self, freq: float) -> None:
        """Set the host's DVFS pacing (relative frequency, nominal 1.0)."""
        if freq <= 0.0:
            raise ValueError(f"freq_scale must be positive, got {freq}")
        self.freq_scale = float(freq)

    @property
    def active_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is not None]

    def _note_compile(self, kind: str, shape) -> None:
        key = (kind, tuple(shape))
        if key not in self._compiled_shapes:
            self._compiled_shapes.add(key)
            self.metrics.inc(f"engine.{kind}_compiles")

    def _insert_slot(self, slot: int, single_cache) -> None:
        # in place: the batch cache's row `slot` takes the prefilled cache
        # (the JAX engine builds a new cache tree instead)
        for pool, one in zip(self.cache, single_cache, strict=True):
            pool["k"][slot] = one["k"][0]
            pool["v"][slot] = one["v"][0]

    # ------------------------------------------------------------------
    def _admit(self) -> None:
        for slot in range(self.max_batch):
            if self.slot_req[slot] is not None:
                continue
            if not self.queue:
                break
            req = self.queue.pop(0)
            plen = len(req.prompt)
            # prompts are right-padded to power-of-2 buckets, so the
            # prefill shapes stay at log2(max_seq); slots >= plen hold
            # padding K/V that decode overwrites before the position mask
            # ever reaches them
            bucket = 1 << max(plen - 1, 1).bit_length()
            bucket = min(bucket, self.max_seq)
            padded = req.prompt + [0] * (bucket - plen)
            prompt = torch.tensor([padded], dtype=torch.long,
                                  device=self.device)
            one_cache = M.init_cache(self.cfg, 1, self.max_seq,
                                     device=self.device)
            self._note_compile("prefill", prompt.shape)
            logits, one_cache = M.forward(self.params, {"tokens": prompt},
                                          cfg=self.cfg, mode="prefill",
                                          cache=one_cache)
            self.n_prefills += 1
            tok = int(sample_tokens(logits[:, plen - 1], self.temperature,
                                    generator=self._gen)[0])
            self._insert_slot(slot, one_cache)
            req.slot = slot
            req.generated.append(tok)
            req.first_token_at = time.time()
            self.positions[slot] = plen
            self.cur_tokens[slot] = tok
            self.slot_req[slot] = req
            self._maybe_finish(slot)

    def evict(self, slot: int, keep_kv: bool = True) -> Optional[Request]:
        """Preempt the request in `slot`, returning it un-finished with its
        partial generation. A dense engine drops the KV (`keep_kv` matters
        only to paged engines); the next admission overwrites the rows."""
        req = self.slot_req[slot]
        if req is None:
            return None
        self.slot_req[slot] = None
        self.positions[slot] = 0
        self.cur_tokens[slot] = 0
        req.slot = -1
        return req

    def _maybe_finish(self, slot: int) -> None:
        req = self.slot_req[slot]
        if req is None:
            return
        last = req.generated[-1]
        if (len(req.generated) >= req.max_new_tokens
                or (req.eos_id >= 0 and last == req.eos_id)
                or self.positions[slot] >= self.max_seq - 1):
            req.done_at = time.time()
            self.completed.append(req)
            self.slot_req[slot] = None
            self.positions[slot] = 0
            self.cur_tokens[slot] = 0

    # ------------------------------------------------------------------
    def step(self) -> int:
        """Admit + one decode step for all slots. Returns #active."""
        self._admit()
        active = self.active_slots
        if not active:
            return 0
        tokens = torch.tensor(self.cur_tokens, dtype=torch.long,
                              device=self.device)[:, None]
        pos = torch.tensor(self.positions, dtype=torch.int32,
                           device=self.device)
        self._note_compile("decode", tokens.shape)
        logits, self.cache = M.decode_step(self.params, tokens, self.cache,
                                           pos, cfg=self.cfg)
        next_tokens = sample_tokens(logits, self.temperature,
                                    generator=self._gen).tolist()
        for slot in active:
            req = self.slot_req[slot]
            req.generated.append(next_tokens[slot])
            self.positions[slot] += 1
            self.cur_tokens[slot] = next_tokens[slot]
            self._maybe_finish(slot)
        return len(active)

    def stats(self) -> dict:
        """Engine-local counters under the canonical key namespace shared
        with ``PerLLMServer.stats`` (old spellings ride along as deprecated
        aliases)."""
        return with_aliases({
            "n_prefills": self.n_prefills,
            "n_prefix_hits": self.n_prefix_hits,
            "kv_prefill_tokens_saved": self.prefix_tokens_reused,
            "n_queued": len(self.queue),
            "n_active": len(self.active_slots),
            "n_served": len(self.completed),
        })

    def run_until_idle(self, max_steps: int = 10_000) -> List[Request]:
        """Step until queue and slots drain. Raises if `max_steps` runs out
        with work still pending."""
        for _ in range(max_steps):
            if not self.queue and not self.active_slots:
                return self.completed
            self.step()
        if self.queue or self.active_slots:
            raise RuntimeError(
                f"run_until_idle: {len(self.queue)} queued and "
                f"{len(self.active_slots)} active requests remain after "
                f"{max_steps} steps")
        return self.completed
