"""Observability of the port: the metrics registry (``registry``), the
request tracer with its per-rank trace files and their merge (``trace``),
the device-memory monitor (``memory``: the entity ledger, ``torch.cuda``
accounting, typed OOM postmortems, admission arithmetic) and the threaded
HTTP base the serving front door stands on (``httpd``), with their classes
re-exported here as ``paddle_tpu.monitor`` re-exports them. The exporter,
the flight recorder, the anomaly detector, the cost and goodput ledgers and
the rest of ``paddle_tpu/monitor`` are ROADMAP queue 1 item 10.

``TRACER`` is the tracer this package was imported with; ``trace.enable``
with keyword arguments builds a new one, which ``trace.TRACER`` names (as
in the JAX package)."""

from paddle_tpu_torch.monitor import httpd, memory, registry, trace
from paddle_tpu_torch.monitor.httpd import ThreadedHTTPServerBase
from paddle_tpu_torch.monitor.memory import OutOfDeviceMemoryError
from paddle_tpu_torch.monitor.registry import (
    REGISTRY, Counter, Gauge, Histogram, Registry, counter, gauge, histogram,
)
from paddle_tpu_torch.monitor.trace import (
    TRACER, TraceContext, Tracer, merge_rank_traces,
)

__all__ = [
    "registry", "trace", "memory", "httpd",
    "ThreadedHTTPServerBase",
    "Tracer", "TraceContext", "TRACER", "merge_rank_traces",
    "Counter", "Gauge", "Histogram", "Registry", "REGISTRY",
    "counter", "gauge", "histogram",
    "OutOfDeviceMemoryError",
]
