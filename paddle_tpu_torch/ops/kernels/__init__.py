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
from paddle_tpu_torch.ops.kernels import layer_norm as _layer_norm
from paddle_tpu_torch.ops.kernels import optimizer as _optimizer
from paddle_tpu_torch.ops.kernels.attention import flash_attention
from paddle_tpu_torch.ops.kernels.layer_norm import fused_layer_norm
from paddle_tpu_torch.ops.kernels.optimizer import fused_adam

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

__all__ = [
    "flash_attention", "fused_adam", "fused_layer_norm", "register_kernel",
    "get_kernel",
    "list_kernels", "get_body", "selected_body", "dispatch",
    "launch_counts", "reset_launch_counts",
]
