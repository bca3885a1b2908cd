"""Serving telemetry: metrics registry, span tracer, SLO health
(DESIGN.md §10).

Three layers, all optional and all zero-cost when disabled:

  * :mod:`repro_torch.obs.registry` — counters / gauges / fixed-bucket
    latency histograms with declared label schemas (§10.1);
  * :mod:`repro_torch.obs.trace` — context-managed spans forming one tree
    per request, with optional ``torch.profiler`` annotations (§10.2);
  * :mod:`repro_torch.obs.health` — per-tenant SLO-budget rates and rebuild
    overlap accounting, drained at the idle tick (§10.3);
  * :mod:`repro_torch.obs.export` — JSON-lines and Prometheus renderers for
    registry snapshots.

``Telemetry`` bundles the three so a serving stack can thread one
object instead of three; ``Telemetry.disabled()`` is the no-op twin.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .export import (read_jsonl, to_jsonl, to_prometheus, validate_file,
                     validate_lines, write_jsonl)
from .health import (HealthConfig, HealthTracker, TenantHealth,
                     check_overhead_budget)
from .registry import (DEFAULT_LATENCY_BUCKETS_S, NULL_REGISTRY, SCHEMA,
                       Counter, Gauge, Histogram, MetricsRegistry,
                       NullRegistry, tenant_label)
from .trace import NULL_TRACER, Span, Tracer


@dataclass
class Telemetry:
    """One handle for the three layers, shared across a serving stack.

    The engine, service, backend, and batcher all accept a
    ``telemetry=`` and record into the same registry, so one
    ``snapshot()`` sees the whole request path.
    """
    registry: MetricsRegistry = field(default_factory=MetricsRegistry)
    tracer: Tracer = field(default_factory=Tracer)
    health: Optional[HealthTracker] = None
    enabled: bool = True

    def __post_init__(self):
        if self.enabled and self.health is None:
            self.health = HealthTracker()

    @classmethod
    def disabled(cls) -> "Telemetry":
        return cls(registry=NULL_REGISTRY, tracer=NULL_TRACER,
                   health=None, enabled=False)

    def stage_histogram(self) -> Histogram:
        """The shared per-stage latency histogram (§10.1): one
        ``observe`` per stage per batch, labeled (stage, tenant)."""
        return self.registry.histogram(
            "stage_latency_seconds",
            "wall time of one serving stage over one batch",
            labels=("stage", "tenant"))


DISABLED = Telemetry.disabled()

__all__ = [
    "Telemetry", "DISABLED",
    "MetricsRegistry", "NullRegistry", "NULL_REGISTRY",
    "Counter", "Gauge", "Histogram",
    "DEFAULT_LATENCY_BUCKETS_S", "SCHEMA", "tenant_label",
    "Tracer", "Span", "NULL_TRACER",
    "HealthTracker", "HealthConfig", "TenantHealth",
    "check_overhead_budget",
    "to_jsonl", "write_jsonl", "read_jsonl", "validate_lines",
    "validate_file", "to_prometheus",
]
