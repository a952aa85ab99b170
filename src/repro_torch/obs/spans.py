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
``model.head``) are entered too. With no span log, or no profiler
recording, no range is entered. The names are listed in
``docs/observability.md``.
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
