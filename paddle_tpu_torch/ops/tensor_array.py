"""LoDTensorArray and the LoD structural ops: the port of
``paddle_tpu/ops/tensor_array.py``.

Parity targets: array_to_lod_tensor / lod_tensor_to_array
(operators/array_to_lod_tensor_op.cc, lod_tensor_to_array_op.cc),
lod_array_length, lod_rank_table (operators/lod_rank_table_op.cc),
max_sequence_len, lod_reset, reorder_lod_tensor_by_rank,
split_lod_tensor / merge_lod_tensor, tensor_array_to_tensor,
shrink_rnn_memory: the machinery behind the reference's DynamicRNN.

A :class:`TensorArray` is a fixed-capacity [T, ...] buffer and a 0-d
length; a write returns a new array. The orders that the LoD ops compute
(rank tables, the rows of a split) are host work in the JAX package too:
the port computes them with the same numpy calls on host copies of the
lengths and the mask, so ties come out the same (``lod_tensor_to_array``
sorts with numpy's default kind, ``lod_rank_table`` stably).
"""

import numpy as np
import torch

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.core.lod import RaggedBatch

__all__ = [
    "TensorArray", "create_array", "array_write", "array_read",
    "array_length", "tensor_array_to_tensor",
    "lod_tensor_to_array", "array_to_lod_tensor",
    "lod_rank_table", "max_sequence_len", "lod_reset",
    "reorder_lod_tensor_by_rank", "split_lod_tensor", "merge_lod_tensor",
    "shrink_rnn_memory", "lod_array_length",
]


def _host(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


class TensorArray:
    """LoDTensorArray parity with value semantics: a [capacity, ...]
    buffer and the current length (a 0-d int32 tensor). Writes return a
    NEW TensorArray."""

    def __init__(self, buffer, length):
        self.buffer = buffer
        self.length = length

    @classmethod
    def empty(cls, capacity, elem_shape, dtype=torch.float32, device=None):
        from paddle_tpu_torch.ops.tensor_ops import _device
        dev = _device(device)
        return cls(torch.zeros((capacity,) + tuple(elem_shape), dtype=dtype,
                               device=dev),
                   torch.zeros((), dtype=torch.int32, device=dev))

    def write(self, i, value):
        i = torch.as_tensor(i, device=self.buffer.device).reshape(())
        buf = self.buffer.index_copy(
            0, i.reshape(1).long(), torch.as_tensor(value).to(
                self.buffer.dtype).reshape((1,) + self.buffer.shape[1:]))
        return TensorArray(buf, torch.maximum(self.length,
                                              (i + 1).to(torch.int32)))

    def read(self, i):
        return self.buffer[i]

    def stack(self):
        """The valid prefix (one host read of the length)."""
        return self.buffer[:int(self.length)]

    def __len__(self):
        return int(self.length)


def create_array(capacity, elem_shape, dtype=torch.float32, device=None):
    return TensorArray.empty(capacity, elem_shape, dtype, device)


def array_write(array, i, x):
    return array.write(i, x)


def array_read(array, i):
    return array.read(i)


def array_length(array):
    """operators/lod_array_length_op.cc."""
    return array.length


lod_array_length = array_length


def tensor_array_to_tensor(array, axis=0):
    """operators/tensor_array_to_tensor_op.cc: the array's valid prefix
    stacked along ``axis``."""
    vals = array.stack()
    return vals if axis == 0 else torch.movedim(vals, 0, axis)


def lod_tensor_to_array(ragged):
    """operators/lod_tensor_to_array_op.cc: a ragged batch as a list of
    per-step tensors, rows in rank order (longest first): entry t holds
    step t of every sequence longer than t. Returns (steps, order, lens),
    the last two numpy."""
    enforce(isinstance(ragged, RaggedBatch), "expects RaggedBatch")
    lengths = _host(ragged.lengths)
    order = np.argsort(-lengths)
    data = ragged.data[torch.as_tensor(order, device=ragged.data.device)]
    lens = lengths[order]
    return ([data[: int((lens > t).sum()), t]
             for t in range(int(lens.max()) if len(lens) else 0)],
            order, lens)


def array_to_lod_tensor(steps, order, lens):
    """operators/array_to_lod_tensor_op.cc: the inverse of the above (a
    RaggedBatch on the steps' device)."""
    n, maxlen = len(lens), len(steps)
    if steps:
        dev, dtype, feat = steps[0].device, steps[0].dtype, steps[0].shape[1:]
    else:
        dev, dtype, feat = torch.device("cpu"), torch.float32, ()
    out = torch.zeros((n, maxlen) + tuple(feat), dtype=dtype, device=dev)
    for t, s in enumerate(steps):
        out[: s.shape[0], t] = s
    inv = torch.as_tensor(np.argsort(order), device=dev)
    return RaggedBatch(out[inv], torch.as_tensor(
        np.asarray(lens)[np.argsort(order)], device=dev))


def lod_rank_table(ragged, level=0):
    """operators/lod_rank_table_op.cc: [(sequence index, length)] by
    descending length, stable."""
    lens = _host(ragged.lengths)
    order = np.argsort(-lens, kind="stable")
    return [(int(i), int(lens[i])) for i in order]


def max_sequence_len(rank_table):
    """operators/max_sequence_len_op.cc."""
    return rank_table[0][1] if rank_table else 0


def lod_reset(ragged, target_lengths):
    """operators/lod_reset_op.cc: the flat data under new sequence
    lengths."""
    flat, _ = ragged.to_lod()
    off = [0]
    for n in target_lengths:
        off.append(off[-1] + int(n))
    return RaggedBatch.from_lod(flat, off, device=ragged.data.device)


def reorder_lod_tensor_by_rank(ragged, rank_table):
    """operators/reorder_lod_tensor_by_rank_op.cc."""
    order = torch.as_tensor([i for i, _ in rank_table], dtype=torch.long,
                            device=ragged.data.device)
    return RaggedBatch(ragged.data[order],
                       ragged.lengths[order.to(ragged.lengths.device)])


def split_lod_tensor(x, mask):
    """operators/split_lod_tensor_op.cc (IfElse's machinery): the rows of
    ``x`` where ``mask`` is true, those where it is false, and the numpy
    index that restores the order."""
    mask = _host(mask).astype(bool).reshape(-1)
    ti, fi = np.nonzero(mask)[0], np.nonzero(~mask)[0]
    restore = np.argsort(np.concatenate([ti, fi]))
    x = torch.as_tensor(x)

    def rows(idx):
        return x[torch.as_tensor(idx, dtype=torch.long, device=x.device)]
    return rows(ti), rows(fi), restore


def merge_lod_tensor(true_rows, false_rows, restore_index):
    """operators/merge_lod_tensor_op.cc: the inverse of split_lod_tensor."""
    allrows = torch.cat([true_rows, false_rows], dim=0)
    return allrows[torch.as_tensor(restore_index, dtype=torch.long,
                                   device=allrows.device)]


def shrink_rnn_memory(mem, rank_table, step):
    """operators/shrink_rnn_memory_op.cc: the rows (in rank order) of the
    sequences still alive at ``step``."""
    return mem[:sum(1 for _, ln in rank_table if ln > step)]
