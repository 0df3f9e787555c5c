"""Embedding row gather: the CUDA kernel's wrapper, its plain PyTorch
version and its gradient.

Port of ``embedding_gather`` in ``paddle_tpu/ops/pallas/embedding.py`` (the
Pallas ``_gather_kernel`` under the ``jax.custom_vjp`` whose backward is
``_gather_bwd``). Both bodies give the meaning of the JAX package's stock
body, ``jnp.take(table, ids, axis=0)``: an id in ``[-h, h)`` selects its row
(a negative id wraps once) and any other id gives a NaN row. (The Pallas body
turns negative ids into NaN rows instead; the port follows the stock one,
which every CPU run of the reference uses.) The kernel is
``csrc/embedding.cu``; CPU tensors take :func:`_embedding_gather_reference`.
When the table requires grad the call goes through :class:`_GatherFunction`,
whose backward is the plain PyTorch port of ``_gather_bwd`` on either device
(an fp32 zero table with ``dy`` index-added; plain jnp in the JAX package).
"""

import ctypes

import torch

from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.ops.kernels import _build, registry

__all__ = ["embedding_gather"]

NAME = "embedding_gather"
#: the NaN of each table dtype, repeated over 32 bits
_NAN_WORDS = {torch.float32: 0x7FC00000, torch.bfloat16: 0x7FC07FC0,
              torch.float16: 0x7E007E00}
_IDS = (torch.int32, torch.int64)
_SIGNATURES = {
    "pt_embedding_gather": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                            ctypes.c_int64, ctypes.c_int, ctypes.c_uint32,
                            ctypes.c_void_p],
}


def embedding_gather(table, ids):
    """``table[ids]`` for a float table [h, d] and integer ids of any shape:
    returns [*ids.shape, d] in the table's dtype, NaN rows where an id is
    outside ``[-h, h)``.

    CPU tensors take the plain PyTorch body; CUDA tensors launch the kernel
    or raise. Differentiable in the table."""
    if torch.is_grad_enabled() and table.requires_grad:
        return _GatherFunction.apply(table, ids)
    return registry.dispatch(NAME, table, ids)


def _valid_rows(ids, h):
    """(flat row index with invalid ids at 0, flat validity mask)."""
    flat = ids.reshape(-1)
    valid = (flat >= -h) & (flat < h)
    idx = torch.where(flat < 0, flat + h, flat)
    return torch.where(valid, idx, 0), valid


class _GatherFunction(torch.autograd.Function):
    """Forward: the registered body. Backward: ``_gather_bwd``
    (embedding.py:84-88): an fp32 zero table with the rows of ``dy``
    index-added at their ids, cast to the table's dtype. Rows of invalid ids
    add nothing, as in ``jnp.take``'s gradient."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.table_shape, ctx.table_dtype = table.shape, table.dtype
        return registry.dispatch(NAME, table, ids)

    @staticmethod
    def backward(ctx, dy):
        (ids,) = ctx.saved_tensors
        h, d = ctx.table_shape
        idx, valid = _valid_rows(ids, h)
        rows = torch.where(valid[:, None], dy.reshape(-1, d).float(), 0.0)
        dt = torch.zeros(h, d, dtype=torch.float32, device=dy.device)
        dt.index_add_(0, idx, rows)
        return dt.to(ctx.table_dtype), None


def _embedding_gather_reference(table, ids):
    """Plain PyTorch ``jnp.take(table, ids, axis=0)`` (fill mode)."""
    h, d = table.shape
    idx, valid = _valid_rows(ids, h)
    rows = torch.where(valid[:, None], table.index_select(0, idx),
                       float("nan"))
    return rows.reshape(*ids.shape, d)


def _embedding_gather_cuda(table, ids):
    """Launch ``csrc/embedding.cu`` on the current stream (no sync)."""
    dev = table.device
    if dev.type != "cuda":
        raise EnforceNotMet(f"{NAME}: the kernel takes CUDA tensors, got a "
                            f"table on {dev}")
    if table.dtype not in _NAN_WORDS or table.dim() != 2 \
            or not table.is_contiguous():
        raise EnforceNotMet(
            f"{NAME}: the table must be a contiguous 2-D float32, bfloat16 "
            f"or float16 tensor, got {table.dtype} shape "
            f"{tuple(table.shape)} strides {table.stride()}")
    if ids.dtype not in _IDS or ids.device != dev:
        raise EnforceNotMet(f"{NAME}: ids must be int32 or int64 on {dev}, "
                            f"got {ids.dtype} on {ids.device}")
    h, d = table.shape
    ids_c = ids.contiguous()
    n = ids_c.numel()
    out = torch.empty(n, d, dtype=table.dtype, device=dev)
    row_bytes = d * table.element_size()
    word = next(w for w in (16, 4, 2) if row_bytes % w == 0
                and table.data_ptr() % w == 0 and out.data_ptr() % w == 0)
    lib = _build.load("embedding", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pt_embedding_gather(
            table.data_ptr(), ids_c.data_ptr(), int(ids_c.dtype == torch.int64),
            out.data_ptr(), n, h, row_bytes, word, _NAN_WORDS[table.dtype],
            stream)
    _build.check_launch(lib, NAME, err)
    registry.get_kernel(NAME).count_launch()
    return out.reshape(*ids.shape, d)
