"""Observability of the port: the metrics registry (``registry``) and the
request tracer the serving scheduler calls (``trace``), with their classes
re-exported here as ``paddle_tpu.monitor`` re-exports them. The exporter,
the flight recorder, the memory, cost and goodput ledgers and the rest of
``paddle_tpu/monitor`` are ROADMAP queue 1 item 10.

``TRACER`` is the tracer this package was imported with; ``trace.enable``
with keyword arguments builds a new one, which ``trace.TRACER`` names (as
in the JAX package)."""

from paddle_tpu_torch.monitor import registry, trace
from paddle_tpu_torch.monitor.registry import (
    REGISTRY, Counter, Gauge, Histogram, Registry, counter, gauge, histogram,
)
from paddle_tpu_torch.monitor.trace import TRACER, TraceContext, Tracer

__all__ = [
    "registry", "trace",
    "Tracer", "TraceContext", "TRACER",
    "Counter", "Gauge", "Histogram", "Registry", "REGISTRY",
    "counter", "gauge", "histogram",
]
