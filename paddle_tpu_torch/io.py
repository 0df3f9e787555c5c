"""fluid.io parity: model save/load (``paddle_tpu/io.py``'s re-exports of
``static/io.py``) and ``batch``, the reader decorator. The eager checkpoints
(``save_pytree``, ``save_dygraph``) and the data loaders are ROADMAP queue 1
item 10."""

from paddle_tpu_torch.static.io import (  # noqa: F401
    load_inference_model, load_params, load_persistables, load_vars,
    save_inference_model, save_params, save_persistables, save_vars,
)

__all__ = ["save_inference_model", "load_inference_model", "save_params",
           "load_params", "save_persistables", "load_persistables",
           "save_vars", "load_vars", "batch"]


def batch(reader, batch_size, drop_last=False):
    """fluid.io.batch / paddle.batch parity: a sample reader as a reader of
    sample lists, the last partial list kept by default."""
    from paddle_tpu_torch.dataio.feeder import batch_reader
    return batch_reader(reader, batch_size, drop_last)
