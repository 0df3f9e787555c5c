"""The static path's ``embedding``: the port of ``paddle_tpu/ops/nn.py``'s
lookup (nn.py:390-411).

``embedding`` routes the gather to the ``embedding_gather`` kernel (a CUDA
tensor launches it or raises; a CPU tensor takes its plain body);
``embedding_reference`` is the same function over the plain body alone, for
shape inference on meta tensors, which never reach the kernel registry.
"""

from paddle_tpu_torch.ops.kernels import embedding as _gather

__all__ = ["embedding", "embedding_reference"]


def _embedding(gather, ids, weight, padding_idx):
    squeeze = ids.dim() > 0 and ids.shape[-1] == 1
    if squeeze:
        ids = ids[..., 0]
    out = gather(weight, ids)
    if padding_idx is not None:
        if padding_idx < 0:  # fluid convention: -1 is the last row
            padding_idx = weight.shape[0] + padding_idx
        out = out.masked_fill((ids == padding_idx)[..., None], 0.0)
    return out


def embedding(ids, weight, padding_idx=None, name=None):
    """lookup_table_op.cc parity: rows of ``weight`` at ``ids`` (a trailing
    axis of 1 is squeezed first), zero rows at ``padding_idx``."""
    return _embedding(_gather.embedding_gather, ids, weight, padding_idx)


def embedding_reference(ids, weight, padding_idx=None, name=None):
    """:func:`embedding` over the plain gather body."""
    return _embedding(_gather._embedding_gather_reference, ids, weight,
                      padding_idx)
