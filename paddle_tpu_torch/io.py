"""fluid.io parity: model save/load (``paddle_tpu/io.py``'s re-exports of
``static/io.py``). The eager checkpoints (``save_pytree``, ``save_dygraph``)
and the data loaders are ROADMAP queue 1 item 10."""

from paddle_tpu_torch.static.io import (  # noqa: F401
    load_inference_model, load_params, load_persistables, load_vars,
    save_inference_model, save_params, save_persistables, save_vars,
)

__all__ = ["save_inference_model", "load_inference_model", "save_params",
           "load_params", "save_persistables", "load_persistables",
           "save_vars", "load_vars"]
