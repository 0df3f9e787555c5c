"""Embedding row gather and scatter-add: the CUDA kernels' wrappers, their
plain PyTorch versions and their gradients.

Port of ``embedding_gather`` and ``embedding_scatter_add`` in
``paddle_tpu/ops/pallas/embedding.py`` (the Pallas ``_gather_kernel`` and
``_scatter_kernel``, each under a ``jax.custom_vjp``: ``_gather_bwd`` and
``_scatter_bwd``). Both bodies of each give the meaning of the JAX package's
stock body: an id in ``[-h, h)`` names its row (a negative id wraps once);
any other id gives a NaN row in the gather (``jnp.take``) and adds nothing
in the scatter-add (``.at[].add``). (The Pallas bodies turn negative ids
into NaN rows, or drop them, instead; the port follows the stock ones,
which every CPU run of the reference uses.) The kernels are
``csrc/embedding.cu``; CPU tensors take :func:`_embedding_gather_reference`
and :func:`_embedding_scatter_add_reference`. The scatter-add kernel sums in
a fixed two-level order (chunks of ``_CHUNK`` sorted positions, then each
row's chunk sums), which :func:`_scatter_add_two_level` emulates for the
checks; the TPU kernel adds a one-hot product in the MXU's order, so what
the port keeps is the stock sum within fp32 rounding, deterministically.

When the table requires grad the gather goes through :class:`_GatherFunction`,
whose backward is the plain PyTorch port of ``_gather_bwd`` on either device
(an fp32 zero table with ``dy`` index-added; plain jnp in the JAX package).
When dst or the updates require grad the scatter-add goes through
:class:`_ScatterAddFunction`, whose backward follows ``_scatter_bwd``.
"""

import ctypes

import torch

from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.ops.kernels import _build, registry

__all__ = ["embedding_gather", "embedding_scatter_add"]

NAME = "embedding_gather"
SCATTER = "embedding_scatter_add"
#: the NaN of each table dtype, repeated over 32 bits
_NAN_WORDS = {torch.float32: 0x7FC00000, torch.bfloat16: 0x7FC07FC0,
              torch.float16: 0x7E007E00}
_IDS = (torch.int32, torch.int64)
_SIGNATURES = {
    "pt_embedding_gather": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                            ctypes.c_int64, ctypes.c_int, ctypes.c_uint32,
                            ctypes.c_void_p],
    "pt_embedding_scatter_sort_bytes": ([ctypes.c_int64, ctypes.c_int64],
                                        ctypes.c_int64),
    "pt_embedding_scatter_sort": [ctypes.c_void_p, ctypes.c_int] + [
        ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 + [ctypes.c_void_p],
    "pt_embedding_scatter_add": [ctypes.c_void_p] * 6 + [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p],
}
#: sorted positions per chunk of the scatter-add's summation order
#: (``kChunk`` in ``csrc/embedding.cu``): the kernel keeps two fp32 partial
#: rows per chunk, and the wrapper sizes that scratch from it
_CHUNK = 256
#: dst and update dtypes of the scatter-add kernel
_SCATTER_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
    _build.require_cuda(NAME, "table", table)
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
    _build.launch(_build.load("embedding", _SIGNATURES), "pt_embedding_gather",
                  NAME, dev, table.data_ptr(), ids_c.data_ptr(),
                  int(ids_c.dtype == torch.int64), out.data_ptr(), n, h,
                  row_bytes, word, _NAN_WORDS[table.dtype])
    return out.reshape(*ids.shape, d)


# ---------------------------------------------------------------------------
# scatter-add
# ---------------------------------------------------------------------------
def embedding_scatter_add(dst, ids, updates):
    """``dst`` [h, d] with ``updates[j]`` added into row ``ids[j]``, out of
    place: returns a new tensor in dst's dtype and leaves dst as it is.
    ``ids`` holds n integers (any shape), ``updates`` is [n, d]. An id in
    ``[-h, -1]`` wraps once; any other id outside ``[0, h)`` adds nothing.
    Each row's updates are summed in fp32 and added to dst once, then
    rounded to dst's dtype; the result is deterministic. The plain body
    sums in ascending j; the kernel in the fixed two-level order of
    :func:`_scatter_add_two_level`, which gives the same bits where a row's
    ids lie in one chunk of ``_CHUNK`` sorted positions and agrees to fp32
    rounding elsewhere.

    CPU tensors take the plain PyTorch body; CUDA tensors launch the
    kernel or raise. Differentiable in dst and the updates."""
    if torch.is_grad_enabled() and (dst.requires_grad
                                    or updates.requires_grad):
        return _ScatterAddFunction.apply(dst, ids, updates)
    return registry.dispatch(SCATTER, dst, ids, updates)


class _ScatterAddFunction(torch.autograd.Function):
    """Forward: the registered body. Backward: ``_scatter_bwd``
    (embedding.py:173-175): dy to dst, and dy's rows at the ids to the
    updates, with the stock gather's meaning (a negative id wraps once, an
    id outside ``[-h, h)`` gives a NaN row)."""

    @staticmethod
    def forward(ctx, dst, ids, updates):
        ctx.save_for_backward(ids)
        ctx.updates_dtype = updates.dtype
        return registry.dispatch(SCATTER, dst, ids, updates)

    @staticmethod
    def backward(ctx, dy):
        (ids,) = ctx.saved_tensors
        d_upd = _embedding_gather_reference(dy, ids.reshape(-1))
        return dy, None, d_upd.to(ctx.updates_dtype)


def _embedding_scatter_add_reference(dst, ids, updates):
    """Plain PyTorch scatter-add with the stock ``.at[].add`` meaning,
    summed in fp32 (``index_add_`` on the CPU adds in ascending j) and added
    to dst once."""
    h, d = dst.shape
    idx, valid = _valid_rows(ids, h)
    rows = torch.where(valid[:, None], updates.reshape(-1, d).float(), 0.0)
    acc = torch.zeros(h, d, dtype=torch.float32, device=dst.device)
    acc.index_add_(0, idx, rows)
    return (dst.float() + acc).to(dst.dtype)


def _scatter_add_two_level(dst, ids, updates, chunk=_CHUNK):
    """The kernel's summation order in plain PyTorch, for checks (no main
    path calls it): the keys (the wrapped row, or h for a dropped id) in a
    stable sort, cut into chunks of ``chunk`` sorted positions. Level 1:
    each piece of a row's run inside one chunk summed in fp32 in ascending
    position from 0. Level 2: a row's piece sums added in ascending chunk
    order from 0, then dst once, rounded to dst's dtype. Rows no id names
    are dst as it is. Each add is one fp32 add of the loops below, in that
    order (``index_add_`` or a sum would order them its own way); the
    loops run over the offset inside a piece, and over a row's pieces, each
    step adding at most once into any one sum."""
    h, d = dst.shape
    out = dst.float().clone()
    idx, valid = _valid_rows(ids, h)
    keys = torch.where(valid, idx, h)
    sk, perm = torch.sort(keys, stable=True)
    n = sk.numel()
    if n:
        upd = updates.reshape(-1, d).float()[perm]
        pos = torch.arange(n, device=sk.device)
        # level 1: pieces are the maximal runs of one key inside one chunk
        new = torch.ones(n, dtype=torch.bool, device=sk.device)
        new[1:] = (sk[1:] != sk[:-1]) | (pos[1:] % chunk == 0)
        piece = torch.cumsum(new, 0) - 1
        first = pos[new]
        off = pos - first[piece]
        part = torch.zeros(first.numel(), d, device=dst.device)
        for t in range(int(off.max()) + 1):
            at = off == t
            part[piece[at]] = part[piece[at]] + upd[at]
        pkey = sk[first]
        keep = pkey < h
        pkey, part = pkey[keep], part[keep]
        if pkey.numel():
            # level 2: each row's pieces in ascending chunk order
            m = pkey.numel()
            rnew = torch.ones(m, dtype=torch.bool, device=sk.device)
            rnew[1:] = pkey[1:] != pkey[:-1]
            row = torch.cumsum(rnew, 0) - 1
            pidx = torch.arange(m, device=sk.device)
            roff = pidx - pidx[rnew][row]
            acc = torch.zeros(int(rnew.sum()), d, device=dst.device)
            for t in range(int(roff.max()) + 1):
                at = roff == t
                acc[row[at]] = acc[row[at]] + part[at]
            rows = pkey[rnew]
            out[rows] = out[rows] + acc
    return out.to(dst.dtype)


def _partials(n, d, device):
    """The kernel's fp32 scratch: two partial rows of d per chunk of
    ``_CHUNK`` sorted positions."""
    return torch.empty(-(-n // _CHUNK), 2, d, dtype=torch.float32,
                       device=device)


def _embedding_scatter_add_cuda(dst, ids, updates):
    """Launch ``csrc/embedding.cu``'s scatter-add on the current stream (no
    sync): the keys in a stable radix sort of their bits (index
    preparation, in scratch whose size the library gives), then the summing
    kernel (level 1, and the copy of the rows no id names) and the join of
    runs that cross a chunk (level 2)."""
    dev = dst.device
    _build.require_cuda(SCATTER, "dst", dst)
    for nm, t in (("dst", dst), ("updates", updates)):
        if t.dtype not in _SCATTER_DTYPES or t.dim() != 2 \
                or not t.is_contiguous() or t.device != dev:
            raise EnforceNotMet(
                f"{SCATTER}: {nm} must be a contiguous 2-D float32 or "
                f"bfloat16 tensor on {dev}, got {t.dtype} shape "
                f"{tuple(t.shape)} strides {t.stride()} on {t.device}")
    h, d = dst.shape
    n = ids.numel()
    if ids.dtype not in _IDS or ids.device != dev \
            or tuple(updates.shape) != (n, d):
        raise EnforceNotMet(
            f"{SCATTER}: ids must be int32 or int64 on {dev} and updates "
            f"[n, {d}] for its n ids, got {ids.dtype} ids of shape "
            f"{tuple(ids.shape)} on {ids.device} and updates "
            f"{tuple(updates.shape)}")
    if h >= 2 ** 31 - 1 or n >= 2 ** 31:
        raise EnforceNotMet(f"{SCATTER}: the kernel takes fewer than 2^31 "
                            f"rows and ids, got h={h}, n={n}")
    if n == 0:
        return dst.clone()
    out = torch.empty_like(dst)
    ids_c = ids.reshape(-1).contiguous()
    lib = _build.load("embedding", _SIGNATURES)
    sorted_keys = torch.empty(n, dtype=torch.int32, device=dev)
    perm = torch.empty(n, dtype=torch.int32, device=dev)
    scratch = torch.empty(lib.pt_embedding_scatter_sort_bytes(n, h),
                          dtype=torch.uint8, device=dev)
    # the sort is index preparation: only the summing launch counts
    _build.launch(lib, "pt_embedding_scatter_sort", SCATTER, dev,
                  ids_c.data_ptr(), int(ids_c.dtype == torch.int64),
                  sorted_keys.data_ptr(), perm.data_ptr(), scratch.data_ptr(),
                  scratch.numel(), n, h, count=False)
    partials = _partials(n, d, dev)
    _build.launch(lib, "pt_embedding_scatter_add", SCATTER, dev,
                  dst.data_ptr(), updates.data_ptr(), sorted_keys.data_ptr(),
                  perm.data_ptr(), partials.data_ptr(), out.data_ptr(), n, h,
                  d, _SCATTER_DTYPES[dst.dtype],
                  _SCATTER_DTYPES[updates.dtype])
    return out
