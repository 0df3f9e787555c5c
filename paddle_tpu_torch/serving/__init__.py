"""The serving subsystem of the port (``paddle_tpu/serving``): continuous
micro-batching over a power-of-two bucket ladder, multi-replica dispatch from
one shared queue, warm boot, typed failures (deadlines, replica quarantine
and respawn, adaptive load shedding), weight-only int8/bf16 serving from an
``export_aot(quantize=...)`` directory, the zero-downtime hot model swap and
the HTTP front door.

Layering: ``resilience`` (typed failures, shed controller, swap watchdog,
tenant fair share; stdlib only), ``scheduler`` (queueing and batching; numpy
and stdlib only), ``replica`` (device-pinned execution, the pool supervisor,
pool roles), ``server`` (the front-end), ``swap`` (gate -> memory admission
-> standby warm boot -> canary -> atomic cutover -> watchdog/rollback, and
the watch-dir deploy mode) and ``frontdoor`` (HTTP/1.1 over ``submit`` with
wire-to-device deadlines, per-tenant admission and graceful drain). The
single-request ``paddle_tpu_torch.inference.Predictor`` stays the simple
embedded path.
"""

from paddle_tpu_torch.serving.resilience import (  # noqa: F401
    DeadlineExceededError, OverloadedError, ReplicaLostError,
    ShedController, SwapFailedError, SwapWatchdog, TenantFairShare,
)
from paddle_tpu_torch.serving.scheduler import (  # noqa: F401
    MicroBatch, MicroBatchScheduler, PendingResult, QueueFullError,
    ServerClosedError, ServerDrainingError, bucket_ladder, pick_bucket,
)
from paddle_tpu_torch.serving.replica import Replica, ReplicaPool  # noqa: F401
from paddle_tpu_torch.serving.server import (  # noqa: F401
    InferenceServer, ServingConfig,
)
from paddle_tpu_torch.serving.swap import SwapController  # noqa: F401
from paddle_tpu_torch.serving.frontdoor import (  # noqa: F401
    FrontDoorConfig, HttpFrontDoor, WireClient, WireReset,
)

__all__ = [
    "InferenceServer", "ServingConfig", "MicroBatchScheduler",
    "MicroBatch", "PendingResult", "Replica", "ReplicaPool",
    "QueueFullError", "ServerClosedError", "ServerDrainingError",
    "DeadlineExceededError", "OverloadedError", "ReplicaLostError",
    "ShedController", "TenantFairShare",
    "SwapController", "SwapFailedError", "SwapWatchdog",
    "FrontDoorConfig", "HttpFrontDoor", "WireClient", "WireReset",
    "bucket_ladder", "pick_bucket",
]
