"""Hand-written CUDA kernels of the port, behind the kernel registry.

Importing this package registers every ported kernel (a plain PyTorch
reference body for CPU tensors, a CUDA kernel body for CUDA tensors) and
re-exports the public wrappers. Nothing is compiled at import: a kernel is
built with nvcc the first time a CUDA tensor reaches it (``_build.py``).
"""

from paddle_tpu_torch.ops.kernels.registry import (  # noqa: F401
    dispatch, get_body, get_kernel, launch_counts, list_kernels,
    register_kernel, reset_launch_counts, selected_body,
)
from paddle_tpu_torch.ops.kernels import attention as _attention
from paddle_tpu_torch.ops.kernels import cross_entropy as _cross_entropy
from paddle_tpu_torch.ops.kernels import embedding as _embedding
from paddle_tpu_torch.ops.kernels import layer_norm as _layer_norm
from paddle_tpu_torch.ops.kernels import matmul as _matmul
from paddle_tpu_torch.ops.kernels import optimizer as _optimizer
from paddle_tpu_torch.ops.kernels.attention import flash_attention
from paddle_tpu_torch.ops.kernels.cross_entropy import softmax_cross_entropy
from paddle_tpu_torch.ops.kernels.embedding import (
    embedding_gather, embedding_scatter_add,
)
from paddle_tpu_torch.ops.kernels.layer_norm import fused_layer_norm
from paddle_tpu_torch.ops.kernels.matmul import (
    fused_matmul, fused_matmul_int8, try_fused_matmul,
)
from paddle_tpu_torch.ops.kernels.optimizer import (
    fused_adam, fused_momentum, fused_sgd,
)

register_kernel(
    _layer_norm.NAME, _layer_norm._layer_norm_reference,
    _layer_norm._layer_norm_cuda,
    source="paddle_tpu_torch/ops/kernels/csrc/layer_norm.cu",
    replaces="paddle_tpu/ops/pallas_kernels.py:443")
register_kernel(
    _attention.NAME, _attention._dense_attention_reference,
    _attention._flash_attention_cuda,
    source="paddle_tpu_torch/ops/kernels/csrc/flash_attention_fwd.cu",
    replaces="paddle_tpu/ops/pallas_kernels.py:86")
register_kernel(
    _attention.DKDV, _attention._flash_bwd_dkdv_reference,
    _attention._flash_bwd_dkdv_cuda,
    source="paddle_tpu_torch/ops/kernels/csrc/flash_attention_bwd.cu",
    replaces="paddle_tpu/ops/pallas_kernels.py:182")
register_kernel(
    _attention.DQ, _attention._flash_bwd_dq_reference,
    _attention._flash_bwd_dq_cuda,
    source="paddle_tpu_torch/ops/kernels/csrc/flash_attention_bwd.cu",
    replaces="paddle_tpu/ops/pallas_kernels.py:230")
register_kernel(
    _optimizer.NAME, _optimizer._fused_adam_reference,
    _optimizer._fused_adam_cuda,
    source="paddle_tpu_torch/ops/kernels/csrc/fused_adam.cu",
    replaces="paddle_tpu/ops/pallas/optimizer.py:138")
register_kernel(
    _embedding.NAME, _embedding._embedding_gather_reference,
    _embedding._embedding_gather_cuda,
    source="paddle_tpu_torch/ops/kernels/csrc/embedding.cu",
    replaces="paddle_tpu/ops/pallas/embedding.py:47")
register_kernel(
    _matmul.NAME, _matmul._fused_matmul_reference,
    _matmul._fused_matmul_cuda,
    source="paddle_tpu_torch/ops/kernels/csrc/fused_matmul.cu",
    replaces="paddle_tpu/ops/pallas/matmul.py:62")
register_kernel(
    _matmul.INT8, _matmul._fused_matmul_int8_reference,
    _matmul._fused_matmul_int8_cuda,
    source="paddle_tpu_torch/ops/kernels/csrc/fused_matmul.cu",
    replaces="paddle_tpu/ops/pallas/matmul.py:62")
register_kernel(
    _optimizer.SGD, _optimizer._fused_sgd_reference,
    _optimizer._fused_sgd_cuda,
    source="paddle_tpu_torch/ops/kernels/csrc/fused_sgd.cu",
    replaces="paddle_tpu/ops/pallas/optimizer.py:83")
register_kernel(
    _optimizer.MOMENTUM, _optimizer._fused_momentum_reference,
    _optimizer._fused_momentum_cuda,
    source="paddle_tpu_torch/ops/kernels/csrc/fused_sgd.cu",
    replaces="paddle_tpu/ops/pallas/optimizer.py:105")
register_kernel(
    _embedding.SCATTER, _embedding._embedding_scatter_add_reference,
    _embedding._embedding_scatter_add_cuda,
    source="paddle_tpu_torch/ops/kernels/csrc/embedding.cu",
    replaces="paddle_tpu/ops/pallas/embedding.py:122")
register_kernel(
    _cross_entropy.NAME, _cross_entropy._xent_reference,
    _cross_entropy._softmax_xent_cuda,
    source="paddle_tpu_torch/ops/kernels/csrc/softmax_xent.cu",
    replaces="paddle_tpu/ops/pallas_kernels.py:567")

__all__ = [
    "embedding_gather", "embedding_scatter_add", "flash_attention",
    "fused_adam", "fused_layer_norm", "fused_matmul", "fused_matmul_int8",
    "fused_momentum", "fused_sgd", "softmax_cross_entropy",
    "try_fused_matmul",
    "register_kernel",
    "get_kernel",
    "list_kernels", "get_body", "selected_body", "dispatch",
    "launch_counts", "reset_launch_counts",
]
