"""The distributed package of the port: so far the host-resident sparse
embedding table (``SparseEmbeddingTable``) the CTR trainer
(``models/deepfm.py``) pulls from and pushes to, and the per-rank heartbeat
and metrics-snapshot files (``health``) the exporter writes beside. The rest of
``paddle_tpu.distributed`` (fleet, the parameter server and its client, the
transpiler, the role makers and the launcher) is ROADMAP queue 1 item 9."""

from paddle_tpu_torch.distributed import health
from paddle_tpu_torch.distributed.sparse_embedding import SparseEmbeddingTable

__all__ = ["SparseEmbeddingTable"]
