"""Telemetry plane (DESIGN.md §17): typed step records, a span-based
flight recorder on one clock, Chrome-trace/Perfetto export, and a stdlib
metrics registry with Prometheus text exposition — over the engine, the
host sampler pool and the adaptive controller."""
from repro_torch.obs.export import (chrome_trace, chrome_trace_events,
                                    write_chrome_trace)
from repro_torch.obs.metrics import (DEFAULT_MS_BUCKETS, Counter, Gauge,
                                     Histogram, MetricsRegistry,
                                     render_registries)
from repro_torch.obs.records import CycleRecord, RecordMapping, StepRecord
from repro_torch.obs.telemetry import EngineMetrics, Telemetry
from repro_torch.obs.tracer import (NULL_SPAN, NULL_TRACER, SPAN_KINDS,
                                    SpanEvent, StepTracer, merge_events)

__all__ = [
    "StepRecord", "CycleRecord", "RecordMapping",
    "StepTracer", "SpanEvent", "SPAN_KINDS", "NULL_TRACER", "NULL_SPAN",
    "merge_events",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "render_registries", "DEFAULT_MS_BUCKETS",
    "chrome_trace", "chrome_trace_events", "write_chrome_trace",
    "Telemetry", "EngineMetrics",
]
