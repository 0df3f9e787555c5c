"""Operators of the port. ``ops.kernels`` holds the hand-written CUDA kernels.

The SelectedRows functions (``ops/selected_rows.py``) are exported here, as
the JAX package's ``paddle_tpu.ops`` exports them."""

from paddle_tpu_torch.ops.selected_rows import (  # noqa: F401
    SelectedRows, get_tensor_from_selected_rows, lookup_sparse_table,
    merge_selected_rows, sparse_sgd_update, split_selected_rows,
)

__all__ = [
    "SelectedRows", "merge_selected_rows", "get_tensor_from_selected_rows",
    "split_selected_rows", "sparse_sgd_update", "lookup_sparse_table",
]
