"""Data feeding: the port of ``paddle_tpu/dataio``: ``DataFeeder``,
``PyReader`` and ``DataLoader``, the file ``FileDataLoader`` over the
native threaded reader (exactly-once resume, ``merge_rank_states``), the
Fluid datasets (``InMemoryDataset``, ``QueueDataset``,
``DatasetFactory``), and the dataset readers: ``dataset`` (the builtin
datasets, synthetic by default), ``parsers`` (the real archive formats),
``common`` (download with md5 check, the idx/CIFAR/digits readers,
``split``/``convert``), ``image`` (decoding and the numpy geometry) and
``text_corpus`` (local text files into BERT's MLM batches)."""

from paddle_tpu_torch.dataio import dataset  # noqa: F401
from paddle_tpu_torch.dataio import image  # noqa: F401
from paddle_tpu_torch.dataio.feeder import DataFeeder, batch_reader  # noqa: F401
from paddle_tpu_torch.dataio.pyreader import DataLoader, PyReader  # noqa: F401
from paddle_tpu_torch.dataio.dataloader import (  # noqa: F401
    FileDataLoader, merge_rank_states,
)
from paddle_tpu_torch.dataio.fluid_dataset import (  # noqa: F401
    DatasetFactory, InMemoryDataset, QueueDataset,
)

__all__ = ["dataset", "image", "DataFeeder", "batch_reader", "PyReader",
           "DataLoader", "FileDataLoader", "merge_rank_states",
           "DatasetFactory", "InMemoryDataset", "QueueDataset"]
