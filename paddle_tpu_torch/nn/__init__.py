"""The module context of the eager (dygraph) API: the port of
``paddle_tpu/nn/__init__.py``'s module names.

``Layer.init(rng, *x) -> (params, state)`` and ``Layer.apply(params, state,
rng, *x) -> (out, new_state)``, with a haiku-like implicit collection
context so layer code reads imperatively (``nn.transform`` for a plain
function); gradients are autograd's over ``apply``. ``params_from_numpy``
carries the JAX ``init``'s dict across, keys kept. The standard Layer
classes are ``nn/layers.py``'s (the 20 that the JAX ``nn`` exports; its
``Conv3D`` and ``Conv3DTranspose`` are under ``nn.layers`` and ``dygraph``,
as there).
"""

from paddle_tpu_torch.nn.module import (  # noqa: F401
    Layer, LayerList, Sequential, create_parameter, create_state,
    current_rng, get_state, in_module_ctx, params_from_numpy, set_state,
    transform,
)
from paddle_tpu_torch.nn.layers import (  # noqa: F401
    FC, NCE, BatchNorm, BilinearTensorProduct, Conv2D, Conv2DTranspose,
    Dropout, Embedding, GroupNorm, GRUCell, GRUUnit, InstanceNorm,
    LayerNorm, Linear, LSTMCell, Pool2D, PRelu, RowConv, SpectralNorm,
    TreeConv,
)

__all__ = ["Layer", "transform", "create_parameter", "create_state",
           "get_state", "set_state", "in_module_ctx", "current_rng",
           "Sequential", "LayerList", "params_from_numpy",
           "Linear", "FC", "Conv2D", "Conv2DTranspose", "Pool2D",
           "BatchNorm", "LayerNorm", "GroupNorm", "InstanceNorm", "Embedding",
           "Dropout", "PRelu", "GRUUnit", "LSTMCell", "GRUCell",
           "SpectralNorm", "NCE", "BilinearTensorProduct", "RowConv",
           "TreeConv"]
