"""The serving engine's span log: where a step's host time goes.

`ServingEngine.spans` holds a `SpanLog` while someone wants the engine's
phases timed (an operator; ``cardbench/tools/spans.py`` on the card), and is
``None`` otherwise, so that a site costs one ``is None`` test. Each span records its
name, its start and end on ``time.perf_counter_ns`` (the clock of the
engine's request stamps, in nanoseconds), the index of the span open
around it (-1 at the top) and a few integer attributes. While a
``torch.profiler`` records, an open span is also a
``torch.profiler.record_function`` range of the same name, so it shows on
the device trace's own timeline; and during a step the model's own ranges
(`model_range`: ``model.norm``, ``model.attn``, ``model.mlp``,
``model.head``, and within them ``model.mla.expand``,
``model.mla.attend``, ``model.moe.route``, ``model.moe.experts``,
``model.moe.shared``) are entered too. With no span log, or no profiler
recording, no range is entered, and a replayed prefill graph enters none
(its kernels fall under ``engine.prefill``). The engine's spans and the
four outer ranges are listed in ``docs/observability.md``.

The ranges inside ``model.attn`` of an MLA layer
(`layers.mla_prefill_attention`, `layers.mla_absorbed_decode`):

* ``model.mla.expand``: at prefill, the latent's up-projection to per-head
  keys and values (``wkv_b``), the shared rope key joined to each head and
  V padded to the qk width; at decode, the queries absorbed into the latent
  (``q_nope`` times ``wkv_b``'s key columns).
* ``model.mla.attend``: at prefill, the flash kernel at head dim nope +
  rope; at decode, the latent attention in float32 over every slot's whole
  cache and the values' up-projection.

The ranges inside ``model.mlp`` of an MoE layer (`moe.moe_layer`,
`moe.moe_layer_capacity`):

* ``model.moe.route``: the float32 router, top-k, the gates (the rule of
  `models.block.Block`) and the combine weights.
* ``model.moe.experts``: the experts' products (every expert for every
  token on the dense dispatch) and their gated sum.
* ``model.moe.shared``: the shared experts' MLP added to it.

``cardbench/tools/spans.py`` reads them with no edit (``device_by_range``
matches ranges by the ``model.`` prefix); no benchmark metric reads them.

Four counters in ``engine.metrics`` (not in ``stats()``), always on, count
the work of these layers by host arithmetic alone (no device read), each
summed over the layers of its kind and zero in a model without them; every
prefill (its bucket) and decode step (every slot) adds to them:

* ``engine.moe_expert_rows``: token-expert rows the MoE dispatch computes:
  every token times every expert on the dense dispatch, each row of the
  (E, C) buffer on the capacity one.
* ``engine.moe_routed_rows``: token-expert rows the gates use, tokens times
  top-k. The first over this is the dense dispatch's waste (E / k, 10.7 on
  DeepSeek-V2-Lite).
* ``engine.mla_decode_positions``: latent positions the MLA decode reads,
  every slot's whole cache (``max_seq``) a step, and each token of a prefix
  hit's suffix.
* ``engine.mla_valid_positions``: the live slots' own positions (position +
  1 each). The first over this is the latent decode's waste.

Tests read them (``tests/test_torch_deepseek_v2.py``), and operators from
``engine.metrics``; ``cardbench/tools/spans.py``'s fixed ``COUNTERS`` do
not include them.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import time

import torch
from torch.profiler import record_function

# a context that does nothing, for a site whose span or range is off
NO_SPAN = contextlib.nullcontext()

# whether the model's ranges are entered: set by `SpanLog.model_ranges` for
# the length of an engine step, per thread
_MODEL_RANGES = contextvars.ContextVar("repro_torch_model_ranges",
                                       default=False)


def profiling() -> bool:
    """A ``torch.profiler`` is recording in this process."""
    return torch.autograd._profiler_enabled()


def model_range(name: str):
    """``record_function(name)`` while an engine step with a span log runs
    under a recording profiler; otherwise `NO_SPAN`."""
    return record_function(name) if _MODEL_RANGES.get() else NO_SPAN


@dataclasses.dataclass
class Span:
    name: str
    t0_ns: int
    t1_ns: int = -1             # -1 while open
    parent: int = -1            # index in `SpanLog.spans` of the span around
    attrs: dict = dataclasses.field(default_factory=dict)

    @property
    def dur_ns(self) -> int:
        return self.t1_ns - self.t0_ns


class SpanLog:
    """Spans in memory, in the order they opened."""

    def __init__(self) -> None:
        self.spans: list[Span] = []
        self._open: list[int] = []

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Time the block as a span named `name` (yields the `Span`, whose
        `attrs` the block may add to)."""
        s = Span(name, time.perf_counter_ns(),
                 parent=self._open[-1] if self._open else -1, attrs=attrs)
        self._open.append(len(self.spans))
        self.spans.append(s)
        try:
            if profiling():
                with record_function(name):
                    yield s
            else:
                yield s
        finally:
            s.t1_ns = time.perf_counter_ns()
            self._open.pop()

    @contextlib.contextmanager
    def model_ranges(self):
        """Enter the model's ranges (`model_range`) in the block, if a
        profiler records."""
        token = _MODEL_RANGES.set(profiling())
        try:
            yield
        finally:
            _MODEL_RANGES.reset(token)
