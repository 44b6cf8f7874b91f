"""Per-engine telemetry bundle: one tracer + one metrics registry
(DESIGN.md §17).

Both engines own a :class:`Telemetry`; the gateway aggregates them —
``GET /metrics`` renders every replica engine's registry with an
injected ``replica`` label next to the gateway's own, and
``GET /v1/trace`` merges the tracers into one Chrome trace.

Defaults encode the overhead contract: **metrics on** (a few locked
float updates per committed step — invisible next to a forward) and
**tracing off** (the flight recorder is a debugging instrument; enable
it per run with ``serve.py --trace-out`` or per engine by passing an
enabled :class:`~repro.obs.tracer.StepTracer`).

:class:`EngineMetrics` is the single definition of the engines' metric
families, so the single-stage and pipeline engines cannot drift apart in
naming — the decomposition the paper argues with (pool stall, sampler
vs transfer time, queue depth/delay, bubble fraction) appears under the
same names for both.
"""
from __future__ import annotations

import math
from typing import Optional

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.records import StepRecord
from repro_torch.obs.tracer import StepTracer


class Telemetry:
    """One engine's observability handle (tracer + metrics registry)."""

    def __init__(self, tracer: Optional[StepTracer] = None,
                 metrics: Optional[MetricsRegistry] = None):
        self.tracer = tracer if tracer is not None else \
            StepTracer(capacity=16384, enabled=False)
        self.metrics = metrics if metrics is not None else MetricsRegistry()


class EngineMetrics:
    """The engines' shared instrument set over a registry.

    ``observe_step`` consumes the same validated :class:`StepRecord`
    stream the controller and benchmarks read — the record IS the
    metrics update, so /metrics can never disagree with ``stats_log``.
    """

    def __init__(self, registry: MetricsRegistry):
        m = self._registry = registry
        self.steps = m.counter(
            "engine_steps_total", "committed engine iterations")
        self.tokens = m.counter(
            "engine_tokens_committed_total",
            "tokens committed to request state")
        self.queue_depth = m.gauge(
            "engine_queue_depth", "requests waiting for admission")
        self.batch = m.gauge(
            "engine_batch_occupancy", "active rows in the last commit")
        self.mode_host = m.gauge(
            "engine_sampler_mode_host",
            "decision-plane placement: 1 = host sampler pool, 0 = device")
        self.pool_workers = m.gauge(
            "engine_pool_workers", "host sampler pool worker count")
        self.stall = m.histogram(
            "engine_pool_stall_ms",
            "commit block on the sampler-pool ticket (host mode)")
        self.sampler = m.histogram(
            "engine_sampler_ms",
            "pool CPU sampling time per step, fetch excluded (max shard)")
        self.transfer = m.histogram(
            "engine_transfer_ms",
            "pool wait on the logits' D2H copy per step (in-flight "
            "compute + copy)")
        self.queue_delay = m.histogram(
            "engine_queue_delay_ms",
            "oldest waiting request's queueing delay at commit")
        self.bubble = m.gauge(
            "pipeline_bubble_frac",
            "Eq. 4 bubble fraction of the last full pipeline cycle "
            "(0 until a pipeline engine reports one)")
        self.decisions = m.counter(
            "controller_decisions_total",
            "decision-plane controller actions applied (any knob)")
        # prefill/decode disaggregation (§18): migration flow + the
        # router-debuggability gauges behind GET /v1/stats and /metrics
        self.migrations_out = m.counter(
            "engine_migrations_out_total",
            "requests exported with their KV (disaggregation, §18)")
        self.migrations_in = m.counter(
            "engine_migrations_in_total",
            "requests imported with carried KV (disaggregation, §18)")
        self.free_blocks = m.gauge(
            "engine_free_kv_blocks",
            "free blocks in the paged KV pool (-1 = contiguous cache)")
        self.pending_imports = m.gauge(
            "engine_pending_imports",
            "admitted-but-not-installed carried-KV requests")
        # the decode step as CUDA graphs (engine/step_graph.py): how often
        # it engages
        self.graph_replays = m.counter(
            "engine_decode_graph_replays_total",
            "decode steps dispatched as CUDA graph replays, every program "
            "of the step (forward, and the decision on the device)")
        self.graph_captures = m.counter(
            "engine_decode_graph_captures_total",
            "CUDA graphs captured of the decode step's programs")

    def cache_bytes(self, kv: int, state: int) -> None:
        """The engine's cache by kind of state, set once at its start
        (the gauges exist only where an engine holds a cache): the
        attention K/V and the recurrent states beside it."""
        self._registry.gauge(
            "engine_cache_kv_bytes",
            "bytes of the cache's attention K/V").set(float(kv))
        self._registry.gauge(
            "engine_cache_state_bytes",
            "bytes of the cache's recurrent states (SSM, conv carry, token "
            "shifts)").set(float(state))

    def observe_step(self, rec: StepRecord) -> None:
        """Fold one committed step's record into the instruments."""
        self.steps.inc()
        self.tokens.inc(rec.batch)
        self.batch.set(rec.batch)
        if rec.queue_depth is not None:
            self.queue_depth.set(rec.queue_depth)
        if rec.queue_delay_ms is not None:
            self.queue_delay.observe(rec.queue_delay_ms)   # NaN dropped
        if rec.stall_ms is not None:
            self.stall.observe(rec.stall_ms)
        if rec.sampler_ms is not None:
            self.sampler.observe(rec.sampler_ms)
        if rec.transfer_ms is not None:
            self.transfer.observe(rec.transfer_ms)
        if rec.bubble_frac is not None and math.isfinite(rec.bubble_frac):
            self.bubble.set(rec.bubble_frac)


__all__ = ["Telemetry", "EngineMetrics"]
