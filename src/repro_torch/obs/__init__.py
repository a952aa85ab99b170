"""Observability: request-lifecycle tracing, metrics registry,
exporters, and the SLO-attribution report CLI (docs/observability.md).

Everything here is opt-in: the runtimes take ``trace=None`` defaults
and a traced run is result-bit-identical to an untraced one.
"""
from repro_torch.obs.export import (
    perfetto_events, validate_perfetto, write_csv, write_perfetto,
)
from repro_torch.obs.metrics import (
    DEPRECATED_ALIASES, MetricsRegistry, counter_attr, with_aliases,
)
from repro_torch.obs.trace import (
    KIND_ARM, KIND_ARRIVAL, KIND_DECISION, KIND_DONE, KIND_INFER,
    KIND_KV_WAIT, KIND_MIGRATE, KIND_NAMES, KIND_PREEMPT, KIND_QUEUE,
    KIND_REJECT, KIND_RESUME, KIND_TX, SPAN_KINDS, TraceRecorder,
)

__all__ = [
    "DEPRECATED_ALIASES", "KIND_ARM", "KIND_ARRIVAL", "KIND_DECISION",
    "KIND_DONE", "KIND_INFER", "KIND_KV_WAIT", "KIND_MIGRATE",
    "KIND_NAMES", "KIND_PREEMPT", "KIND_QUEUE", "KIND_REJECT",
    "KIND_RESUME", "KIND_TX", "MetricsRegistry", "SPAN_KINDS",
    "TraceRecorder", "counter_attr", "perfetto_events",
    "validate_perfetto", "with_aliases", "write_csv", "write_perfetto",
]
