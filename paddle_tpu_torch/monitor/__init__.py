"""Observability of the port, one module for each of the JAX package's
``paddle_tpu/monitor``, with its classes re-exported here as that package
re-exports them:

- ``registry``: process-wide Counter/Gauge/Histogram with labels; the
  write path is lock-free (thread-local shards merged on read).
- ``exporter``: Prometheus text-format snapshots written atomically next
  to each rank's heartbeat file (``distributed/health.py``), the
  ``/metrics`` endpoint (``MetricsServer``) and the job-level aggregation.
- ``flight_recorder``: a bounded ring of recent spans and steps that dumps
  a postmortem JSON on a crash, SIGTERM or an anomaly.
- ``cost``: FLOPs and bytes per step from an abstract pass of the
  Executor's prepared runner on ``meta`` tensors, and the MFU estimate.
- ``trace``: per-request and per-step span trees, tail sampling, per-rank
  trace files and their merge.
- ``numerics``: the ``FLAGS_check_nan_inf`` sentinels and the bisecting
  localizer naming the first non-finite tensor and op.
- ``tensorwatch``: grad and param norms, the update ratio and the AMP loss
  scale riding the step's fetch.
- ``anomaly``: the windowed detector (loss spike, grad explosion, step
  stall, non-finite) and the straggler and health readout.
- ``goodput``: every wall-clock second of a job attributed to a phase, and
  the incarnation ledger ``tools/goodput_report.py`` reads.
- ``memory``: the entity ledger, ``torch.cuda`` accounting, the measured
  per-step peak, typed OOM postmortems and admission arithmetic.
- ``httpd``: the threaded HTTP base of the front door and the metrics
  endpoint.

Metric names, kinds and labels are the JAX package's (docs/OBSERVABILITY.md's
catalogue), so a dashboard or tool written for one package reads the other.

``TRACER`` is the tracer this package was imported with; ``trace.enable``
with keyword arguments builds a new one, which ``trace.TRACER`` names (as
in the JAX package)."""

from paddle_tpu_torch.monitor import anomaly
from paddle_tpu_torch.monitor import cost
from paddle_tpu_torch.monitor import exporter
from paddle_tpu_torch.monitor import flight_recorder
from paddle_tpu_torch.monitor import goodput
from paddle_tpu_torch.monitor import httpd
from paddle_tpu_torch.monitor import memory
from paddle_tpu_torch.monitor import numerics
from paddle_tpu_torch.monitor import registry
from paddle_tpu_torch.monitor import tensorwatch
from paddle_tpu_torch.monitor import trace
from paddle_tpu_torch.monitor.anomaly import AnomalyDetector
from paddle_tpu_torch.monitor.exporter import (
    MetricsServer, RankExporter, render_text, write_snapshot,
)
from paddle_tpu_torch.monitor.flight_recorder import RECORDER, FlightRecorder
from paddle_tpu_torch.monitor.httpd import ThreadedHTTPServerBase
from paddle_tpu_torch.monitor.memory import OutOfDeviceMemoryError
from paddle_tpu_torch.monitor.numerics import NonFiniteError
from paddle_tpu_torch.monitor.registry import (
    REGISTRY, Counter, Gauge, Histogram, Registry, counter, gauge, histogram,
)
from paddle_tpu_torch.monitor.tensorwatch import TensorMonitor
from paddle_tpu_torch.monitor.trace import (
    TRACER, TraceContext, Tracer, merge_rank_traces,
)

__all__ = [
    "registry", "exporter", "flight_recorder", "cost", "numerics",
    "tensorwatch", "anomaly", "trace", "memory", "goodput", "httpd",
    "ThreadedHTTPServerBase",
    "Tracer", "TraceContext", "TRACER", "merge_rank_traces",
    "Counter", "Gauge", "Histogram", "Registry", "REGISTRY",
    "counter", "gauge", "histogram",
    "RankExporter", "MetricsServer", "render_text", "write_snapshot",
    "FlightRecorder", "RECORDER",
    "NonFiniteError", "TensorMonitor", "AnomalyDetector",
    "OutOfDeviceMemoryError",
]
