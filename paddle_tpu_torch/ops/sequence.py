"""Sequence ops over RaggedBatch (dense padding + lengths): the port of
``paddle_tpu/ops/sequence.py``.

Parity targets: operators/sequence_ops/ (sequence_pool, sequence_softmax,
sequence_expand, sequence_pad/unpad, sequence_concat, sequence_reverse,
sequence_mask, sequence_slice, sequence_erase, sequence_enumerate,
sequence_first/last_step, sequence_conv, sequence_reshape). Every op is a
masked dense computation over the padded batch, as in the JAX package; the
lengths stay on their device and no op reads them on the host, except
``sequence_reshape``'s divisibility check, which runs only on CPU lengths.

Sequence inputs are ``RaggedBatch`` (data [B, T, ...], lengths [B]) or a
(data, lengths) pair. No op here reaches a Pallas kernel in the JAX
package, and none reaches a kernel of the port.
"""

import torch

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.core.lod import RaggedBatch, sequence_mask

__all__ = [
    "sequence_mask", "sequence_pool", "sequence_softmax", "sequence_expand",
    "sequence_pad", "sequence_unpad", "sequence_concat", "sequence_reverse",
    "sequence_first_step", "sequence_last_step", "sequence_slice",
    "sequence_scatter", "sequence_expand_as", "sequence_conv",
    "sequence_reshape", "sequence_enumerate", "sequence_erase",
]


def _unpack(x):
    if isinstance(x, RaggedBatch):
        return x.data, x.lengths
    if isinstance(x, (tuple, list)) and len(x) == 2:
        return torch.as_tensor(x[0]), torch.as_tensor(x[1])
    raise TypeError("sequence op needs RaggedBatch or (data, lengths)")


def _mask(data, lengths):
    m = sequence_mask(lengths, maxlen=data.shape[1], dtype=data.dtype)
    return m.reshape(m.shape + (1,) * (data.dim() - 2))


def _trail(idx, data):
    """``idx`` [B, T'] broadcast over data's trailing dims, for a gather
    along dim 1."""
    return idx.reshape(idx.shape + (1,) * (data.dim() - 2)).expand(
        idx.shape + data.shape[2:])


def _lowest(dtype):
    return (torch.finfo(dtype).min if dtype.is_floating_point
            else torch.iinfo(dtype).min)


def sequence_pool(input, pool_type="sum", name=None):
    """sequence_pool_op parity: reduce each sequence over time; [B, ...].
    ``max`` takes the dtype's lowest value on padding (a zero-length row
    gives it), ``average`` and ``sqrt`` divide by max(length, 1)."""
    data, lengths = _unpack(input)
    m = _mask(data, lengths)
    pt = pool_type.lower()
    denom = torch.clamp(lengths, min=1).to(data.dtype)
    denom = denom.reshape((-1,) + (1,) * (data.dim() - 2))
    if pt == "sum":
        return torch.sum(data * m, dim=1)
    if pt in ("average", "mean"):
        return torch.sum(data * m, dim=1) / denom
    if pt == "sqrt":
        return torch.sum(data * m, dim=1) / torch.sqrt(denom)
    if pt == "max":
        low = torch.full((), _lowest(data.dtype), dtype=data.dtype,
                         device=data.device)
        return torch.amax(torch.where(m > 0, data, low), dim=1)
    if pt == "first":
        return data[:, 0]
    if pt == "last":
        return sequence_last_step(input)
    raise ValueError(f"unknown pool_type {pool_type}")


def sequence_first_step(input, name=None):
    data, _ = _unpack(input)
    return data[:, 0]


def sequence_last_step(input, name=None):
    data, lengths = _unpack(input)
    idx = torch.clamp(lengths - 1, min=0).long()
    return torch.gather(data, 1, _trail(idx[:, None], data))[:, 0]


def sequence_softmax(input, name=None):
    """sequence_softmax_op parity: softmax within each sequence, padding
    excluded (and zero)."""
    data, lengths = _unpack(input)
    m = _mask(data, lengths)
    low = torch.full((), torch.finfo(data.dtype).min, dtype=data.dtype,
                     device=data.device)
    out = torch.softmax(torch.where(m > 0, data, low), dim=1)
    return RaggedBatch(out * m, lengths)


def sequence_expand(x, y, ref_level=-1, name=None):
    """sequence_expand_op parity, dense form: each row of x ([B, ...], one
    entry per sequence) repeated over y's time axis, masked by y's
    lengths: RaggedBatch [B, T, ...]."""
    ydata, ylen = _unpack(y)
    xb = torch.as_tensor(x)
    out = xb[:, None].expand((xb.shape[0], ydata.shape[1]) + xb.shape[1:])
    return RaggedBatch(out * _mask(out, ylen), ylen)


def sequence_expand_as(x, y, name=None):
    return sequence_expand(x, y)


def sequence_pad(x, pad_value=0.0, maxlen=None, name=None):
    """sequence_pad_op parity: re-pad to ``maxlen`` (cut or extend) and
    fill the padding with ``pad_value``; returns (data, lengths), the
    reference's (Out, Length)."""
    data, lengths = _unpack(x)
    if maxlen is not None and maxlen != data.shape[1]:
        if maxlen > data.shape[1]:
            fill = torch.full(
                (data.shape[0], maxlen - data.shape[1]) + data.shape[2:],
                pad_value, dtype=data.dtype, device=data.device)
            data = torch.cat([data, fill], dim=1)
        else:
            data = data[:, :maxlen]
    m = _mask(data, lengths)
    pad = torch.full((), pad_value, dtype=data.dtype, device=data.device)
    return torch.where(m > 0, data, pad), lengths


def sequence_unpad(x, length, name=None):
    """sequence_unpad_op parity: dense (x, length) as a RaggedBatch."""
    return RaggedBatch(torch.as_tensor(x), torch.as_tensor(length))


def sequence_concat(input, name=None):
    """sequence_concat_op parity: per batch row, the valid steps of each
    input one after the other along time; [B, sum of T, ...] with the
    lengths summed. Each valid step lands at its row's running offset (a
    scatter of disjoint positions, exact)."""
    datas, lens = zip(*[_unpack(t) for t in input])
    total = sum(d.shape[1] for d in datas)
    b = datas[0].shape[0]
    out = torch.zeros((b, total) + datas[0].shape[2:], dtype=datas[0].dtype,
                      device=datas[0].device)
    offs = torch.zeros((b,), dtype=torch.int64, device=out.device)
    for d, ln in zip(datas, lens):
        t = d.shape[1]
        steps = torch.arange(t, device=out.device)
        valid = steps[None, :] < ln[:, None]
        tpos = torch.where(valid, steps[None, :] + offs[:, None], 0)
        vm = valid.reshape(valid.shape + (1,) * (d.dim() - 2))
        out = out.scatter_add(1, _trail(tpos, d),
                              torch.where(vm, d, torch.zeros_like(d)))
        offs = offs + ln
    return RaggedBatch(out, sum(lens))


def sequence_reverse(x, name=None):
    """sequence_reverse_op parity: each row's valid prefix reversed, the
    padding left in place."""
    data, lengths = _unpack(x)
    t = data.shape[1]
    pos = torch.arange(t, dtype=torch.int64, device=data.device)[None, :]
    src = lengths[:, None].long() - 1 - pos
    src = torch.where(src >= 0, src, pos)
    return RaggedBatch(torch.gather(data, 1, _trail(src, data)), lengths)


def sequence_slice(input, offset, length, name=None):
    """sequence_slice_op parity: per sequence, [offset, offset + length)
    (positions clipped into the row)."""
    data, _ = _unpack(input)
    offset = torch.as_tensor(offset, device=data.device).reshape(-1)
    length = torch.as_tensor(length, device=data.device).reshape(-1)
    maxl = data.shape[1]
    pos = torch.arange(maxl, dtype=torch.int64, device=data.device)[None, :]
    src = torch.clamp(pos + offset[:, None].long(), 0, maxl - 1)
    out = torch.gather(data, 1, _trail(src, data))
    return RaggedBatch(out, length.to(torch.int32))


def sequence_scatter(x, index, updates, name=None):
    """sequence_scatter_op parity (dense): ``updates`` added at
    ``index`` [B, K] of each row, repeated positions summed."""
    x = torch.as_tensor(x)
    idx = torch.as_tensor(index, device=x.device).long()
    rows = torch.arange(x.shape[0], device=x.device)[:, None].expand_as(idx)
    return x.index_put((rows, idx), torch.as_tensor(updates,
                                                    device=x.device),
                       accumulate=True)


def sequence_conv(input, filter, context_length, context_start=None,
                  name=None):
    """sequence_conv_op parity (ref: operators/sequence_ops/
    sequence_conv_op.cc): context-window convolution over time.

    ``input`` is RaggedBatch / (data [B, T, H], lengths) or a dense
    [B, T, H] tensor; ``filter`` is [context_length * H, num_filters] (the
    reference's im2col-then-matmul layout, operators/math/
    context_project.h). Padded steps are zeroed before the window gather
    (``torch.roll`` plus an edge mask, as ``jnp.roll`` is used there), so
    results match the reference's LoD behaviour at sequence boundaries.
    """
    if isinstance(input, (RaggedBatch, tuple, list)):
        data, lengths = _unpack(input)
        data = data * _mask(data, lengths)
    else:
        data, lengths = torch.as_tensor(input), None
    b, t, h = data.shape
    if context_start is None:
        context_start = -((context_length - 1) // 2)
    steps = torch.arange(t, device=data.device)
    cols = []
    for k in range(context_length):
        off = context_start + k
        shifted = torch.roll(data, -off, dims=1)
        m = steps >= -off if off < 0 else steps < t - off
        cols.append(shifted * m[None, :, None].to(data.dtype))
    ctx = torch.cat(cols, dim=-1)                    # [B, T, cl*H]
    out = ctx @ torch.as_tensor(filter)              # [B, T, F]
    if lengths is not None:
        return RaggedBatch(out * _mask(out, lengths), lengths)
    return out


def sequence_reshape(input, new_dim, name=None):
    """sequence_reshape_op parity (ref sequence_ops/sequence_reshape_op.cc):
    each sequence's flattened (length_i * M) elements re-chunked into rows
    of ``new_dim``: [B, T, M] -> [B, T*M/new_dim, new_dim] with lengths
    ``lengths * M / new_dim`` (each payload is a row-major prefix of the
    flat [T*M] buffer, so only tail padding moves; the buffer is padded
    when T*M is not a multiple of new_dim). The reference requires each
    length_i * M to divide by new_dim: checked on CPU lengths; lengths on
    the card are not read on the host, and an indivisible payload there is
    cut short, as in the JAX package under a trace."""
    data, lengths = _unpack(input)
    enforce(data.dim() == 3,
            "sequence_reshape expects ragged [B, T, M] input")
    b, t, m = data.shape
    nd = int(new_dim)
    if lengths.device.type == "cpu":
        ln = lengths.numpy()
        bad = ln[(ln * m) % nd != 0]
        enforce(bad.size == 0,
                f"sequence payloads {bad.tolist()[:4]} * M={m} not "
                f"divisible by new_dim={nd} "
                f"(sequence_reshape_op.cc contract)")
    total = t * m
    pad = (-total) % nd
    flat = data.reshape(b, total)
    if pad:
        flat = torch.cat([flat, flat.new_zeros(b, pad)], dim=1)
    out = flat.reshape(b, (total + pad) // nd, nd)
    new_len = torch.div(lengths * m, nd, rounding_mode="floor")
    return RaggedBatch(out, new_len.to(torch.int32))


def sequence_enumerate(input, win_size, pad_value=0, name=None):
    """sequence_enumerate_op parity: every position emits the window of
    ``win_size`` ids starting there; positions past the sequence's end
    (window overhang included) read ``pad_value``. Ragged [B, T] ->
    RaggedBatch([B, T, win_size], lengths)."""
    data, lengths = _unpack(input)
    enforce(data.dim() == 2, "sequence_enumerate expects ragged [B, T]")
    b, t = data.shape
    idx = (torch.arange(t, device=data.device)[:, None]
           + torch.arange(int(win_size), device=data.device)[None, :])
    gathered = data[:, torch.clamp(idx, max=t - 1)]            # [B,T,W]
    valid = idx[None] < lengths[:, None, None]
    pad = torch.full((), pad_value, dtype=data.dtype, device=data.device)
    return RaggedBatch(torch.where(valid, gathered, pad), lengths)


def sequence_erase(input, tokens, name=None):
    """sequence_erase_op parity: every occurrence of ``tokens`` deleted
    from each sequence, the survivors compacted to the front by a stable
    sort on the keep mask (the dense [B, T] shape kept, the lengths
    shrunk, padding 0)."""
    data, lengths = _unpack(input)
    enforce(data.dim() == 2, "sequence_erase expects ragged [B, T]")
    b, t = data.shape
    toks = torch.as_tensor(list(tokens), dtype=data.dtype,
                           device=data.device).reshape(-1)
    steps = torch.arange(t, device=data.device)[None, :]
    in_range = steps < lengths[:, None]
    erase = torch.any(data[:, :, None] == toks[None, None, :], dim=-1)
    keep = in_range & ~erase
    order = torch.sort((~keep).to(torch.int32), dim=1, stable=True).indices
    out = torch.gather(data, 1, order)
    new_len = torch.sum(keep, dim=1).to(torch.int32)
    mask = steps < new_len[:, None]
    return RaggedBatch(torch.where(mask, out, torch.zeros_like(out)),
                       new_len)
