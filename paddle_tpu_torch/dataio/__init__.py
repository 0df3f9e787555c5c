"""Data feeding: the port of ``paddle_tpu/dataio``'s ``DataFeeder``,
``PyReader`` and ``DataLoader``, the file ``FileDataLoader`` over the
native threaded reader (exactly-once resume, ``merge_rank_states``) and
the Fluid datasets (``InMemoryDataset``, ``QueueDataset``,
``DatasetFactory``). The dataset readers (``dataset``, ``image`` and their
parsers) are ROADMAP queue 1 item 10 step 2b."""

from paddle_tpu_torch.dataio.feeder import DataFeeder, batch_reader  # noqa: F401
from paddle_tpu_torch.dataio.pyreader import DataLoader, PyReader  # noqa: F401
from paddle_tpu_torch.dataio.dataloader import (  # noqa: F401
    FileDataLoader, merge_rank_states,
)
from paddle_tpu_torch.dataio.fluid_dataset import (  # noqa: F401
    DatasetFactory, InMemoryDataset, QueueDataset,
)

__all__ = ["DataFeeder", "batch_reader", "PyReader", "DataLoader",
           "FileDataLoader", "merge_rank_states", "DatasetFactory",
           "InMemoryDataset", "QueueDataset"]
