"""Ragged sequence batches: the port of ``paddle_tpu/core/lod.py``.

The reference threads variable-length sequence structure through every
sequence op as offset-based "level of detail" metadata on a flat tensor
(ref: paddle/fluid/framework/lod_tensor.h:110, offset doc :229). The JAX
package replaces it by **dense padding + explicit lengths**, and so does
the port:

- ``RaggedBatch``: data padded to [batch, max_len, ...] and ``lengths``
  [batch] int32, torch tensors on one device;
- masks are derived on demand (``sequence_mask``, ``RaggedBatch.mask``)
  as float tensors on the data's device: a sequence op reads no length on
  the host.

``from_list`` and ``from_lod`` build on the card unless ``device`` says
otherwise, as the port's other entry points do.
"""

import numpy as np
import torch

__all__ = ["RaggedBatch", "sequence_mask"]


def _device(device):
    from paddle_tpu_torch import resolve_device
    return resolve_device(device)


class RaggedBatch:
    """Dense-padded batch of variable-length sequences.

    data:    [batch, max_len, ...] padded values
    lengths: [batch] int32 valid lengths
    """

    def __init__(self, data, lengths):
        self.data = data
        self.lengths = lengths

    # -- construction ------------------------------------------------------
    @classmethod
    def from_list(cls, seqs, max_len=None, dtype=None, pad_value=0,
                  device=None):
        """Build from a list of per-sequence arrays or lists, on ``device``
        (the card when None)."""
        seqs = [np.asarray(s) for s in seqs]
        lengths = np.array([len(s) for s in seqs], dtype=np.int32)
        max_len = int(max_len or (lengths.max() if len(seqs) else 0))
        tail = seqs[0].shape[1:] if seqs else ()
        dtype = dtype or (seqs[0].dtype if seqs else np.float32)
        if isinstance(dtype, torch.dtype):
            dtype = torch.empty((), dtype=dtype).numpy().dtype
        out = np.full((len(seqs), max_len) + tail, pad_value, dtype=dtype)
        for i, s in enumerate(seqs):
            out[i, : len(s)] = s[:max_len]
        dev = _device(device)
        return cls(torch.from_numpy(out).to(dev),
                   torch.from_numpy(lengths).to(dev))

    @classmethod
    def from_lod(cls, flat_data, lod, max_len=None, device=None):
        """Build from the reference's (flat values, offsets) form (ref:
        lod_tensor.h:229 offset-based LoD)."""
        flat_data = np.asarray(flat_data)
        offsets = np.asarray(lod[-1] if isinstance(
            lod[0], (list, tuple, np.ndarray)) else lod)
        seqs = [flat_data[offsets[i]: offsets[i + 1]]
                for i in range(len(offsets) - 1)]
        return cls.from_list(seqs, max_len=max_len, device=device)

    # -- views -------------------------------------------------------------
    @property
    def batch_size(self):
        return self.data.shape[0]

    @property
    def max_len(self):
        return self.data.shape[1]

    @property
    def shape(self):
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype

    def mask(self, dtype=torch.float32):
        """[batch, max_len] 1/0 validity mask on the data's device."""
        pos = torch.arange(self.max_len, dtype=torch.int32,
                           device=self.lengths.device)[None, :]
        return (pos < self.lengths[:, None]).to(dtype)

    def segment_ids(self):
        """Flat [batch*max_len] ids, padding marked with its row's index
        too: combine with the mask for segment reductions."""
        return torch.arange(self.batch_size, dtype=torch.int32,
                            device=self.data.device).repeat_interleave(
                                self.max_len)

    def to_lod(self):
        """(flat concatenated values, offsets) as numpy, on the host."""
        lens = self.lengths.detach().cpu().numpy()
        data = self.data.detach().cpu().numpy()
        flat = np.concatenate([data[i, : lens[i]] for i in range(len(lens))],
                              axis=0) if len(lens) \
            else data.reshape((0,) + data.shape[2:])
        offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
        return flat, [offsets.tolist()]

    def __repr__(self):
        return (f"RaggedBatch(shape={tuple(self.data.shape)}, "
                f"dtype={self.data.dtype}, lengths={self.lengths})")


def sequence_mask(lengths, maxlen=None, dtype=torch.float32):
    """fluid.layers.sequence_mask parity (ref: python/paddle/fluid/layers/
    nn.py sequence_mask). ``maxlen`` is required, as in the JAX package
    (there it must be static under jit; here it keeps the mask's shape
    free of a host read of the lengths)."""
    lengths = torch.as_tensor(lengths)
    if maxlen is None:
        raise ValueError("maxlen must be given: pass it explicitly (the "
                         "mask's width is not read from the lengths)")
    pos = torch.arange(maxlen, dtype=lengths.dtype, device=lengths.device)
    return (pos[None, :] < lengths[:, None]).to(dtype)
