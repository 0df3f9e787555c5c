"""The serving subsystem of the port (``paddle_tpu/serving``): continuous
micro-batching over a power-of-two bucket ladder, multi-replica dispatch from
one shared queue, warm boot, typed failures (deadlines, replica quarantine
and respawn, adaptive load shedding) and weight-only int8/bf16 serving from
an ``export_aot(quantize=...)`` directory.

Layering: ``resilience`` (typed failures, shed controller; stdlib only),
``scheduler`` (queueing and batching; numpy and stdlib only), ``replica``
(device-pinned execution and the pool supervisor), ``server`` (the
front-end) and ``swap`` (the served version's gauge). The single-request
``paddle_tpu_torch.inference.Predictor`` stays the simple embedded path.

Not ported yet (ROADMAP queue 1 item 8): the hot model swap and watch-dir
deploys, and the HTTP front door.
"""

from paddle_tpu_torch.serving.resilience import (  # noqa: F401
    DeadlineExceededError, OverloadedError, ReplicaLostError,
    ShedController,
)
from paddle_tpu_torch.serving.scheduler import (  # noqa: F401
    MicroBatch, MicroBatchScheduler, PendingResult, QueueFullError,
    ServerClosedError, ServerDrainingError, bucket_ladder, pick_bucket,
)
from paddle_tpu_torch.serving.replica import Replica, ReplicaPool  # noqa: F401
from paddle_tpu_torch.serving.server import (  # noqa: F401
    InferenceServer, ServingConfig,
)

__all__ = [
    "InferenceServer", "ServingConfig", "MicroBatchScheduler",
    "MicroBatch", "PendingResult", "Replica", "ReplicaPool",
    "QueueFullError", "ServerClosedError", "ServerDrainingError",
    "DeadlineExceededError", "OverloadedError", "ReplicaLostError",
    "ShedController", "bucket_ladder", "pick_bucket",
]
