"""fluid.lod_tensor helpers: the port of ``paddle_tpu/lod_tensor.py``.

Parity: python/paddle/fluid/lod_tensor.py (create_lod_tensor,
create_random_int_lodtensor). The LoD form is ``core.lod.RaggedBatch``
(dense padding + explicit lengths), built from the reference's
recursive_sequence_lengths format. ``place`` says where the batch lives:
``CPUPlace()`` the host, None the card (the port's default device).
"""

import numpy as np

from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.core.lod import RaggedBatch
from paddle_tpu_torch.core.place import place_device

__all__ = ["create_lod_tensor", "create_random_int_lodtensor"]


def _innermost_lengths(recursive_seq_lens):
    """Validate a multi-level recursive_sequence_lengths structure and
    return the innermost level's per-sequence row counts. Mirrors the
    reference's has_valid_recursive_sequence_lengths: each outer level's
    sum must equal the next level's sequence count."""
    if not recursive_seq_lens:
        raise EnforceNotMet("recursive_seq_lens must be non-empty")
    for lvl in recursive_seq_lens:
        if not isinstance(lvl, (list, tuple)) or not lvl:
            raise EnforceNotMet(
                "recursive_seq_lens must be a non-empty list of "
                "non-empty lists")
    for outer, inner in zip(recursive_seq_lens, recursive_seq_lens[1:]):
        if int(np.sum(outer)) != len(inner):
            raise EnforceNotMet(
                f"invalid recursive_seq_lens: outer level sums to "
                f"{int(np.sum(outer))} but the next level has "
                f"{len(inner)} sequences")
    return list(recursive_seq_lens[-1])


def create_lod_tensor(data, recursive_seq_lens, place=None):
    """fluid.create_lod_tensor parity: a ragged batch from flat row data
    and recursive sequence lengths, on ``place``.

    data: an array or tensor of shape [sum(lens), ...], or a list of
    per-sequence lists (each becoming a [len, 1] column group, the
    reference's list form).
    """
    lens = _innermost_lengths(recursive_seq_lens)
    if isinstance(data, list):
        # the lengths are checked before the reshape, so a mismatch
        # reports as EnforceNotMet, not a numpy error
        if [len(s) for s in data] != lens:
            raise EnforceNotMet(
                f"recursive_seq_lens {lens} does not match data "
                f"lengths {[len(s) for s in data]}")
        width = max((np.asarray(s).reshape(len(s), -1).shape[1]
                     for s in data if len(s)), default=1)
        flat = np.concatenate(
            [np.asarray(s).reshape(len(s), -1) if len(s)
             else np.zeros((0, width)) for s in data], axis=0)
    else:
        flat = data.detach().cpu().numpy() if hasattr(data, "detach") \
            else np.asarray(data)
        if flat.shape[0] != int(np.sum(lens)):
            raise EnforceNotMet(
                f"sum(recursive_seq_lens[-1])={int(np.sum(lens))} != "
                f"data rows {flat.shape[0]}")
    seqs, off = [], 0
    for n in lens:
        seqs.append(flat[off:off + n])
        off += n
    rb = RaggedBatch.from_list(seqs, device=place_device(place))
    rb.recursive_seq_lens = [list(l) for l in recursive_seq_lens]
    return rb


def create_random_int_lodtensor(recursive_seq_lens, base_shape, place=None,
                                low=0, high=10, seed=None):
    """fluid.create_random_int_lodtensor parity: int64 values drawn from
    numpy's ``RandomState(seed)`` in [low, high], rows of ``base_shape``
    (the JAX package's draws, value for value)."""
    lens = _innermost_lengths(recursive_seq_lens)
    total = int(np.sum(lens))
    rng = np.random.RandomState(seed)
    flat = rng.randint(low, high + 1,
                       size=[total] + list(base_shape)).astype(np.int64)
    return create_lod_tensor(flat, recursive_seq_lens, place)
