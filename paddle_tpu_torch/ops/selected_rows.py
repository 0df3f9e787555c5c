"""SelectedRows: sparse row-set tensors for embedding gradients.

The port of ``paddle_tpu/ops/selected_rows.py``. Parity targets:
framework/selected_rows.{h,cc} (rows + value block of a conceptually
[height, ...] tensor), operators/merge_selected_rows_op.cc (sum duplicate
rows), split/get ops (operators/split_selected_rows_op.cc,
get_tensor_from_selected_rows_op.cc), lookup_sparse_table
(operators/lookup_sparse_table_op.cc) and the sgd kernel's sparse branch
(operators/optimizers/sgd_op.cc SelectedRows path).

A (rows, values, height) triple of tensors. Merging, densifying and the
sparse SGD update are scatter-adds into a new tensor (out of place, as in
the JAX package) through the ``embedding_scatter_add`` kernel on the card
and its plain body on the CPU; values with other than two dims are
flattened to [n, row size] and go through the same function.
``split_selected_rows`` and ``lookup_sparse_table`` work on the host.
"""

from typing import NamedTuple

import numpy as np
import torch

from paddle_tpu_torch.ops.kernels.embedding import embedding_scatter_add

__all__ = [
    "SelectedRows", "merge_selected_rows", "get_tensor_from_selected_rows",
    "split_selected_rows", "sparse_sgd_update", "lookup_sparse_table",
]


class SelectedRows(NamedTuple):
    rows: torch.Tensor      # [n] int row indices (may repeat before merge)
    values: torch.Tensor    # [n, ...] row payloads
    height: int             # logical dim-0 of the dense tensor


def _scatter_add(dense, rows, values):
    """``dense`` with ``values[j]`` added into row ``rows[j]``, as a new
    tensor: the scatter-add kernel on [h, row size] views."""
    h = dense.shape[0]
    out = embedding_scatter_add(dense.reshape(h, -1), rows.reshape(-1),
                                values.reshape(values.shape[0], -1))
    return out.reshape(dense.shape)


def merge_selected_rows(sr):
    """Sum duplicate rows (merge_selected_rows_op.cc). Returns
    (merged, valid): the unique rows sorted ascending, padded to n with row
    0, their summed values (zeros in the padding) and ``valid`` [n] bool,
    False on the padding, as the JAX package's fixed-size merge gives
    them."""
    rows = torch.as_tensor(sr.rows).reshape(-1)
    n = rows.shape[0]
    uniq, inv = torch.unique(rows, sorted=True, return_inverse=True)
    uniq = torch.cat([uniq, uniq.new_full((n - uniq.shape[0],), -1)])
    summed = _scatter_add(
        torch.zeros((n,) + tuple(sr.values.shape[1:]),
                    dtype=sr.values.dtype, device=sr.values.device),
        inv, sr.values)
    valid = uniq >= 0
    return (SelectedRows(torch.where(valid, uniq, 0), summed, sr.height),
            valid)


def get_tensor_from_selected_rows(sr):
    """Densify (get_tensor_from_selected_rows_op.cc): a new
    [height, ...] tensor."""
    dense = torch.zeros((sr.height,) + tuple(sr.values.shape[1:]),
                        dtype=sr.values.dtype, device=sr.values.device)
    return _scatter_add(dense, sr.rows, sr.values)


def split_selected_rows(sr, num_splits):
    """split_selected_rows_op.cc: shard rows by range over pservers —
    shard i owns rows [i*h/k, (i+1)*h/k). Each shard's tensors lie on the
    device of ``sr.rows``."""
    bounds = [sr.height * i // num_splits for i in range(num_splits + 1)]
    dev = torch.as_tensor(sr.rows).device
    rows = torch.as_tensor(sr.rows).cpu().numpy()
    vals = torch.as_tensor(sr.values).cpu()
    out = []
    for i in range(num_splits):
        m = (rows >= bounds[i]) & (rows < bounds[i + 1])
        out.append(SelectedRows(
            torch.as_tensor(rows[m] - bounds[i], device=dev),
            vals[torch.as_tensor(m)].to(dev), bounds[i + 1] - bounds[i]))
    return out


def sparse_sgd_update(param, sr_grad, lr):
    """sgd_op.cc SelectedRows branch: ``param`` minus ``lr`` times the
    gradient's rows, touching only those rows, as a new tensor."""
    return _scatter_add(param, sr_grad.rows, -lr * sr_grad.values)


def lookup_sparse_table(table_dict, ids, dim, init_fn=None, seed=0,
                        device=None):
    """lookup_sparse_table_op.cc: auto-growing host-side table lookup
    (a python dict of id -> numpy row). A missing row is drawn with
    ``init_fn(rng)`` from ``np.random.RandomState(seed)`` (default: normal,
    std 0.01, float32), the rows the JAX package draws. Returns the rows
    [len(ids), dim] as an fp32 tensor on ``device`` (the card by
    default)."""
    from paddle_tpu_torch import resolve_device
    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    init_fn = init_fn or (
        lambda r: r.normal(0, 0.01, dim).astype(np.float32))
    ids = ids.cpu().numpy() if isinstance(ids, torch.Tensor) else ids
    out = np.empty((len(ids), dim), np.float32)
    for i, x in enumerate(np.asarray(ids).reshape(-1)):
        row = table_dict.get(int(x))
        if row is None:
            row = init_fn(rng)
            table_dict[int(x)] = row
        out[i] = row
    return torch.as_tensor(out, device=device)
