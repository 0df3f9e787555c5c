"""Data feeding: the port of ``paddle_tpu/dataio``'s ``DataFeeder`` and the
worker-thread ``PyReader`` that ``layers.io`` needs. The rest of the JAX
package's ``dataio`` (DataLoader, datasets, file loaders) is not ported yet
(ROADMAP queue 1 item 10)."""

from paddle_tpu_torch.dataio.feeder import DataFeeder, batch_reader  # noqa: F401
from paddle_tpu_torch.dataio.pyreader import PyReader  # noqa: F401

__all__ = ["DataFeeder", "batch_reader", "PyReader"]
