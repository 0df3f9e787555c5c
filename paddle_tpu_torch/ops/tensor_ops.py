"""Tensor manipulation ops: the port of ``paddle_tpu/ops/tensor_ops.py``,
every public function.

Parity targets: concat_op.cc, split_op.cc, stack_op.cc, unstack_op.cc,
squeeze_op.cc, unsqueeze_op.cc, reshape_op.cc, flatten_op.cc,
transpose_op.cc, slice_op.cc, gather_op.cc, scatter_op.cc, expand_op.cc,
shape_op.cc, fill_constant_op.cc, fill_any_like_op.cc, assign_op.cc,
arg_max/arg_min/argsort_op.cc, top_k_op.cc, where_op.cc, diag_op.cc,
linspace_op.cc, range_op.cc, reverse_op.cc, unique_op.cc, size_op.cc,
is_empty_op.cc, multiplex_op.cc, crop_op.cc.

Indices come out int64 where the JAX functions ask for int64 (``argmax``,
``argsort``, ``topk``, ``size``). ``argsort`` and ``topk`` are stable: a tie
keeps the lower index first, as ``jnp.argsort`` and ``lax.top_k`` do.

The functions that make a tensor from nothing (``fill_constant``,
``zeros``, ``ones``, ``linspace``, ``arange``, ``eye``, ``create_tensor``)
take a trailing ``device``: None is the card, except while a Program is
being built, where the value becomes a program constant on the CPU (the
Executor moves constants to its device), as the JAX package evaluates such
an op at once in static mode.
"""

import builtins

import torch

from paddle_tpu_torch.core.dtypes import convert_dtype

builtins_slice = builtins.slice
builtins_list = builtins.list

__all__ = [
    "concat", "split", "stack", "unstack", "squeeze", "unsqueeze",
    "reshape", "flatten", "transpose", "slice", "strided_slice", "gather",
    "gather_nd", "scatter", "scatter_nd_add", "expand", "expand_as",
    "tile", "shape", "size", "fill_constant", "fill_constant_batch_size_like",
    "zeros", "ones", "zeros_like", "ones_like", "full_like", "assign",
    "argmax", "argmin", "argsort", "topk", "where", "where_index", "diag",
    "linspace", "arange", "reverse", "unique", "unique_with_counts",
    "is_empty", "has_inf", "has_nan", "rank", "create_tensor",
    "multiplex", "crop", "roll", "flip", "meshgrid", "eye",
]


def _t(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def _device(device):
    """Where a tensor made from nothing goes (see the module docstring)."""
    if device is not None:
        return torch.device(device)
    from paddle_tpu_torch.static.program import in_static_mode
    if in_static_mode():
        return torch.device("cpu")
    from paddle_tpu_torch import resolve_device
    return resolve_device(None)


def concat(input, axis=0, name=None):
    return torch.cat([_t(t) for t in input], dim=axis)


def split(input, num_or_sections, dim=-1, name=None):
    """split_op.cc as the JAX op computes it: an int splits into that many
    equal parts (a size it does not divide raises); a list splits at the
    running sums of all its entries but the last, so the last part takes
    the rest. Returns a list."""
    if isinstance(num_or_sections, int):
        n = input.shape[dim]
        if n % num_or_sections:
            raise ValueError(f"split: dim {dim} of size {n} does not divide "
                             f"into {num_or_sections} equal parts")
        return builtins_list(torch.split(input, n // num_or_sections,
                                         dim=dim))
    cuts, at = [], 0
    for s in num_or_sections[:-1]:
        at += int(s)
        cuts.append(at)
    return builtins_list(torch.tensor_split(input, cuts, dim=dim))


def stack(x, axis=0, name=None):
    return torch.stack([_t(t) for t in x], dim=axis)


def unstack(x, axis=0, num=None, name=None):
    return builtins_list(torch.unbind(_t(x), dim=axis))


def squeeze(input, axes=None, name=None):
    input = _t(input)
    if not axes:
        return torch.squeeze(input)
    axes = [a for a in axes if input.shape[a] == 1]
    return torch.squeeze(input, dim=tuple(axes)) if axes else input


def unsqueeze(input, axes, name=None):
    input = _t(input)
    if isinstance(axes, int):
        axes = [axes]
    for a in sorted(axes):
        input = torch.unsqueeze(input, a)
    return input


def reshape(x, shape, inplace=False, name=None):
    """reshape_op.cc parity including the 0-entry rule: a 0 in ``shape``
    copies the input's dim at that position (-1 infers as usual)."""
    x = _t(x)
    shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    return torch.reshape(x, shape)


def flatten(x, axis=1, name=None):
    """flatten_op.cc parity: collapse dims [0, axis) and [axis, ndim)."""
    x = _t(x)
    lead = 1
    for d in x.shape[:axis]:
        lead *= d
    return x.reshape(lead, -1)


def transpose(x, perm, name=None):
    return _t(x).permute(*perm)


def slice(input, axes, starts, ends, name=None):
    """slice_op.cc parity: a negative start or end counts from the end, a
    positive one is clipped to the dim."""
    input = _t(input)
    idx = [builtins_slice(None)] * input.dim()
    for ax, st, en in zip(axes, starts, ends):
        dim = input.shape[ax]
        st2 = st + dim if st < 0 else min(st, dim)
        en2 = en + dim if en < 0 else min(en, dim)
        idx[ax] = builtins_slice(st2, en2)
    return input[tuple(idx)]


def strided_slice(input, axes, starts, ends, strides, name=None):
    """Python slicing per axis, negative strides included."""
    input = _t(input)
    for ax, st, en, sd in zip(axes, starts, ends, strides):
        pos = range(*builtins_slice(st, en, sd).indices(input.shape[ax]))
        input = torch.index_select(
            input, ax, torch.tensor(builtins_list(pos), dtype=torch.long,
                                    device=input.device))
    return input


def _rows(index):
    index = _t(index)
    if index.dim() == 2 and index.shape[1] == 1:
        index = index[:, 0]
    return index.long()


def gather(input, index, overwrite=True, name=None):
    """gather_op.cc parity: rows of ``input`` along axis 0 (an [N, 1] index
    is read as [N])."""
    return _t(input)[_rows(index)]


def gather_nd(input, index, name=None):
    input, index = _t(input), _t(index).long()
    return input[tuple(torch.movedim(index, -1, 0))]


def scatter(input, index, updates, overwrite=True, name=None):
    """scatter_op.cc parity: write (or add) update rows at ``index``; out of
    place."""
    input, index = _t(input), _rows(index)
    if overwrite:
        out = input.clone()
        out[index] = _t(updates).to(input.dtype)
        return out
    return input.index_add(0, index, _t(updates).to(input.dtype))


def scatter_nd_add(ref, index, updates, name=None):
    ref, index = _t(ref), _t(index).long()
    return ref.index_put(tuple(torch.movedim(index, -1, 0)),
                         _t(updates).to(ref.dtype), accumulate=True)


def expand(x, expand_times, name=None):
    """expand_op.cc parity: dim i tiled ``expand_times[i]`` times."""
    return torch.tile(_t(x), tuple(expand_times))


def expand_as(x, target_tensor, name=None):
    x = _t(x)
    times = [t // s for s, t in zip(x.shape, target_tensor.shape)]
    return torch.tile(x, tuple(times))


def tile(x, repeat_times, name=None):
    return torch.tile(_t(x), tuple(repeat_times))


def shape(input, name=None):
    input = _t(input)
    return torch.tensor(input.shape, dtype=torch.int32, device=input.device)


def size(input, name=None):
    input = _t(input)
    return torch.tensor(input.numel(), dtype=torch.int64, device=input.device)


def fill_constant(shape, dtype, value, name=None, device=None):
    return torch.full(tuple(int(s) for s in shape), value,
                      dtype=convert_dtype(dtype), device=_device(device))


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0,
                                  name=None):
    input = _t(input)
    shape = builtins_list(shape)
    shape[output_dim_idx] = input.shape[input_dim_idx]
    return torch.full(tuple(shape), value, dtype=convert_dtype(dtype),
                      device=input.device)


def zeros(shape, dtype="float32", name=None, device=None):
    return torch.zeros(tuple(shape), dtype=convert_dtype(dtype),
                       device=_device(device))


def ones(shape, dtype="float32", name=None, device=None):
    return torch.ones(tuple(shape), dtype=convert_dtype(dtype),
                      device=_device(device))


def zeros_like(x, out=None, name=None):
    return torch.zeros_like(_t(x))


def ones_like(x, out=None, name=None):
    return torch.ones_like(_t(x))


def full_like(x, fill_value, dtype=None, name=None):
    return torch.full_like(_t(x), fill_value,
                           dtype=convert_dtype(dtype) if dtype else None)


def assign(input, output=None, name=None):
    return _t(input)


def argmax(x, axis=0, name=None):
    return torch.argmax(_t(x), dim=axis).to(torch.int64)


def argmin(x, axis=0, name=None):
    return torch.argmin(_t(x), dim=axis).to(torch.int64)


def argsort(input, axis=-1, descending=False, name=None):
    """argsort_op.cc parity: (sorted, indices), stable; descending sorts
    the negated input, as the JAX op does."""
    input = _t(input)
    idx = torch.argsort(-input if descending else input, dim=axis,
                        stable=True)
    return torch.take_along_dim(input, idx, dim=axis), idx.to(torch.int64)


def topk(input, k, name=None):
    """top_k_op.cc parity over the last axis: (values, indices), the lower
    index first among equal values."""
    input = _t(input)
    vals, idx = torch.sort(input, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int64)


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return where_index(condition)
    return torch.where(_t(condition).to(torch.bool), _t(x), _t(y))


def where_index(condition, name=None):
    """where_op.cc parity: the indices of the true elements, row-major. The
    count is data-dependent: eager only, as in the JAX package."""
    return torch.nonzero(_t(condition))


def diag(diagonal, name=None):
    return torch.diag(_t(diagonal))


def linspace(start, stop, num, dtype="float32", name=None, device=None):
    return torch.linspace(start, stop, int(num), dtype=convert_dtype(dtype),
                          device=_device(device))


def arange(start, end=None, step=1, dtype="float32", name=None,
           device=None):
    if end is None:
        start, end = 0, start
    return torch.arange(start, end, step, dtype=convert_dtype(dtype),
                        device=_device(device))


def reverse(x, axis, name=None):
    if isinstance(axis, int):
        axis = (axis,)
    return torch.flip(_t(x), dims=tuple(axis))


def flip(x, axis, name=None):
    return reverse(x, axis)


def roll(x, shifts, axis=None, name=None):
    return torch.roll(_t(x), shifts, dims=axis)


def unique_with_counts(x, dtype="int32", name=None):
    """unique_op.cc parity: (sorted unique values, each element's index in
    them, in x's shape, as ``np.unique`` gives it; counts). The count is
    data-dependent: eager only."""
    x = _t(x)
    out, index, counts = torch.unique(x.reshape(-1), sorted=True,
                                      return_inverse=True,
                                      return_counts=True)
    dt = convert_dtype(dtype)
    return out, index.reshape(x.shape).to(dt), counts.to(dt)


def is_empty(x, name=None):
    x = _t(x)
    return torch.tensor(x.numel() == 0, device=x.device)


def multiplex(inputs, index, name=None):
    """multiplex_op.cc parity: row i of ``inputs[index[i]]``."""
    stacked = torch.stack([_t(t) for t in inputs], dim=0)
    idx = _t(index).reshape(-1).long()
    rows = torch.arange(stacked.shape[1], device=stacked.device)
    return stacked[idx, rows]


def crop(x, shape=None, offsets=None, name=None):
    x = _t(x)
    offsets = offsets or [0] * x.dim()
    return x[tuple(builtins_slice(o, o + s) for o, s in zip(offsets, shape))]


def meshgrid(*args):
    """``jnp.meshgrid(indexing="ij")``: each input keeps its dtype."""
    args = [_t(a).reshape(-1) for a in args]
    shape = tuple(a.shape[0] for a in args)
    return [a.reshape([-1 if j == k else 1 for j in range(len(args))])
            .expand(shape) for k, a in enumerate(args)]


def eye(num_rows, num_columns=None, dtype="float32", device=None):
    return torch.eye(num_rows, num_rows if num_columns is None
                     else num_columns, dtype=convert_dtype(dtype),
                     device=_device(device))


def unique(x, dtype="int32", name=None):
    """fluid.layers.unique parity: (out, index), ``index`` mapping each
    element of x to its position in ``out`` (eager only)."""
    out, index, _ = unique_with_counts(x, dtype=dtype)
    return out, index


def has_inf(x, name=None):
    """fluid.layers.has_inf: one bool, any inf."""
    return torch.any(torch.isinf(_t(x)))


def has_nan(x, name=None):
    """fluid.layers.has_nan: one bool, any nan."""
    return torch.any(torch.isnan(_t(x)))


def rank(input, name=None):
    """fluid.layers.rank: a 0-d int32 tensor holding the number of dims."""
    input = _t(input)
    return torch.tensor(input.dim(), dtype=torch.int32, device=input.device)


def create_tensor(dtype="float32", name=None, persistable=False,
                  device=None):
    """fluid.layers.tensor.create_tensor parity: an empty typed tensor to
    be filled later (eagerly: 0 elements)."""
    return torch.zeros((0,), dtype=convert_dtype(dtype),
                       device=_device(device))

