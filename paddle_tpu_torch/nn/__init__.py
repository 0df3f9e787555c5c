"""The module context of the eager (dygraph) API: the port of
``paddle_tpu/nn/__init__.py``'s module names.

``Layer.init(rng, *x) -> (params, state)`` and ``Layer.apply(params, state,
rng, *x) -> (out, new_state)``, with a haiku-like implicit collection
context so layer code reads imperatively (``nn.transform`` for a plain
function); gradients are autograd's over ``apply``. ``params_from_numpy``
carries the JAX ``init``'s dict across, keys kept. The 22 Layer classes of
``paddle_tpu/nn/layers.py`` are not ported yet (ROADMAP queue 1 item 7d).
"""

from paddle_tpu_torch.nn.module import (  # noqa: F401
    Layer, LayerList, Sequential, create_parameter, create_state,
    current_rng, get_state, in_module_ctx, params_from_numpy, set_state,
    transform,
)

__all__ = ["Layer", "transform", "create_parameter", "create_state",
           "get_state", "set_state", "in_module_ctx", "current_rng",
           "Sequential", "LayerList", "params_from_numpy"]
