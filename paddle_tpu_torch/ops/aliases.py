"""Long-tail reference op names that are thin primitives: the port of
``paddle_tpu/ops/aliases.py``. ``range`` shadows the builtin, hence a module
of their own.

- ``range`` canonicalises its dtype as the JAX package does with x64 off:
  an int64 request gives int32, float64 gives float32. Its ``device``
  follows the creation ops (None: the card, or a CPU constant while a
  Program is built).
- ``alloc_continuous_space`` returns the flat buffer and views of it. Here
  the views are true views: a write through one shows in the buffer and
  the other way round, where the JAX package's arrays are immutable.
- ``beam_search_decode`` backtracks with a loop over the T steps of gathers
  on the tensors' device: no value is read on the host.
"""

import builtins
import math

import torch

from paddle_tpu_torch.core.dtypes import convert_dtype
from paddle_tpu_torch.ops.tensor_ops import _device, _t

__all__ = ["range", "alloc_continuous_space", "rnn_memory_helper",
           "delete_var", "beam_search_decode"]

_X64_OFF = {torch.int64: torch.int32, torch.float64: torch.float32}


def range(start, end=None, step=1, dtype="int64", device=None):  # noqa: A001
    """operators/range_op.cc (fluid.layers.range): the arithmetic sequence
    [start, end) with stride ``step``, cast to ``dtype``."""
    if end is None:
        start, end = 0, start
    dt = convert_dtype(dtype)
    dt = _X64_OFF.get(dt, dt)
    return torch.arange(start, end, step, device=_device(device)).to(dt)


def alloc_continuous_space(inputs, set_constant=None):
    """operators/alloc_continuous_space_op.cc: one flat buffer holding the
    tensors of ``inputs`` (or ``set_constant`` everywhere), and views of its
    segments in the inputs' shapes. Returns (flat, views)."""
    inputs = [_t(x) for x in inputs]
    sizes = [math.prod(x.shape) for x in inputs]
    if set_constant is not None:
        flat = torch.full((builtins.sum(sizes),), set_constant,
                          dtype=inputs[0].dtype, device=inputs[0].device)
    else:
        flat = torch.cat([x.reshape(-1) for x in inputs])
    views, off = [], 0
    for x, sz in zip(inputs, sizes):
        views.append(flat[off:off + sz].view(x.shape))
        off += sz
    return flat, views


def rnn_memory_helper(x):
    """operators/rnn_memory_helper_op.cc: the identity (autograd carries the
    memory across steps)."""
    return _t(x)


def delete_var(scope, *names):
    """operators/delete_var_op.cc: drop variables from a Scope."""
    for n in names:
        scope.drop_var(n)


def beam_search_decode(step_ids, step_parents, end_token=None):
    """operators/beam_search_decode_op.cc: backtrack the per-step beam
    selections ([T, B*beam] tokens and the beam slot each extended, the
    outputs of ``ops.beam_search`` stacked over steps) into [B*beam, T]
    sequences. With ``end_token``, every position after a sequence's first
    end_token becomes end_token (the reference op's truncation, kept
    static-shape)."""
    step_ids, step_parents = _t(step_ids), _t(step_parents)
    t_steps, bb = step_ids.shape
    beam = torch.arange(bb, device=step_ids.device)
    toks = []
    for t in builtins.range(t_steps - 1, -1, -1):
        toks.append(step_ids[t][beam])
        beam = step_parents[t][beam].long()
    seqs = torch.stack(toks[::-1], dim=1)                 # [BB, T]
    if end_token is not None:
        ended = torch.cumsum((seqs == end_token).int(), dim=1) > 0
        after_end = torch.cat([torch.zeros_like(ended[:, :1]),
                               ended[:, :-1]], dim=1)
        seqs = torch.where(after_end, seqs.new_full((), end_token), seqs)
    return seqs
