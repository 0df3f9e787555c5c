"""Fused softmax cross-entropy: the CUDA kernel's wrapper, its plain PyTorch
version and its gradient.

Port of ``softmax_cross_entropy`` in ``paddle_tpu/ops/pallas_kernels.py``
(the Pallas ``_xent_kernel`` under the ``jax.custom_vjp`` whose backward is
``_softmax_xent_bwd``). Both bodies give the meaning of the JAX package's
stock body, ``_xent_reference``: fp32 max, logsumexp and the label's logit
picked by ``take_along_axis``, where a label in ``[-V, -1]`` wraps once and
any other label outside ``[0, V)`` picks NaN. (The Pallas body compares
labels with the column index instead, so such a label picks nothing and its
loss is the logsumexp; the port follows the stock body, which every CPU run
of the reference uses.) The kernel is ``csrc/softmax_xent.cu``; CPU tensors
take :func:`_xent_reference`. Both bodies return (loss, lse). When the
logits require grad the call goes through :class:`_SoftmaxXentFunction`,
which saves lse; its backward is the plain PyTorch port of
``_softmax_xent_bwd`` on either device.
"""

import ctypes

import torch

from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.ops.kernels import _build, registry

__all__ = ["softmax_cross_entropy"]

NAME = "softmax_cross_entropy"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_LABELS = (torch.int32, torch.int64)
_SIGNATURES = {
    "pt_softmax_xent": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                        ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                        ctypes.c_void_p],
}


def softmax_cross_entropy(logits, labels, block_n=128):
    """Per-example softmax cross-entropy in one pass over the class axis.

    ``logits`` [..., V] in float32 or bfloat16, ``labels`` [...] of an
    integer dtype. Returns fp32 losses [...]: logsumexp(logits) minus the
    label's logit, NaN where a label lies outside ``[-V, V)`` (a negative
    label wraps once). ``block_n`` (the Pallas body's row block) is
    accepted and ignored: the kernel gives each row a block of its own.

    CPU tensors take the plain PyTorch body; CUDA tensors launch the
    kernel or raise. Differentiable in the logits."""
    del block_n
    if labels.dtype not in _LABELS:
        labels = labels.long()
    if torch.is_grad_enabled() and logits.requires_grad:
        return _SoftmaxXentFunction.apply(logits, labels)
    return registry.dispatch(NAME, logits, labels)[0]


def _wrapped_labels(labels, v):
    """(labels with [-V, -1] wrapped and invalid ones at 0, validity)."""
    lab = labels.long()
    valid = (lab >= -v) & (lab < v)
    lab = torch.where(lab < 0, lab + v, lab)
    return torch.where(valid, lab, 0), valid


class _SoftmaxXentFunction(torch.autograd.Function):
    """Forward: the registered body, lse saved. Backward:
    ``_softmax_xent_bwd`` (pallas_kernels.py:615-621): dx = (exp(x - lse) -
    onehot(label)) * dloss in fp32, cast to the logits' dtype. The one-hot
    of a wrapped label sits at its wrapped column; a label outside
    ``[-V, V)`` has none, as the stock gather's gradient gives."""

    @staticmethod
    def forward(ctx, logits, labels):
        loss, lse = registry.dispatch(NAME, logits, labels)
        ctx.save_for_backward(logits, labels, lse)
        return loss

    @staticmethod
    def backward(ctx, dloss):
        logits, labels, lse = ctx.saved_tensors
        v = logits.shape[-1]
        x = logits.float()
        p = torch.exp(x - lse[..., None])
        lab, valid = _wrapped_labels(labels, v)
        onehot = torch.zeros_like(p).scatter_(
            -1, lab[..., None], valid[..., None].float())
        dx = (p - onehot) * dloss[..., None]
        return dx.to(logits.dtype), None


def _xent_reference(logits, labels, block_n=128):
    """Plain PyTorch ``_xent_reference`` (pallas_kernels.py:627-636):
    (loss, lse), both fp32."""
    del block_n
    x = logits.float()
    m = x.amax(-1)
    lse = m + torch.log(torch.exp(x - m[..., None]).sum(-1))
    lab, valid = _wrapped_labels(labels, x.shape[-1])
    picked = torch.gather(x, -1, lab[..., None])[..., 0]
    picked = torch.where(valid, picked, float("nan"))
    return lse - picked, lse


def _softmax_xent_cuda(logits, labels, block_n=128):
    """Launch ``csrc/softmax_xent.cu`` on the current stream (no sync)."""
    del block_n
    dev = logits.device
    _build.require_cuda(NAME, "logits", logits)
    if logits.dtype not in _DTYPE_CODES or logits.dim() < 1 \
            or not logits.is_contiguous() or logits.shape[-1] == 0:
        raise EnforceNotMet(
            f"{NAME}: logits must be a contiguous float32 or bfloat16 "
            f"tensor [..., V] with V > 0, got {logits.dtype} shape "
            f"{tuple(logits.shape)} strides {logits.stride()}")
    lead, v = tuple(logits.shape[:-1]), logits.shape[-1]
    if labels.dtype not in _LABELS or labels.device != dev \
            or tuple(labels.shape) != lead:
        raise EnforceNotMet(
            f"{NAME}: labels must be int32 or int64 {list(lead)} on {dev}, "
            f"got {labels.dtype} {tuple(labels.shape)} on {labels.device}")
    labels = labels.contiguous()
    n = logits.numel() // v
    loss = torch.empty(lead, dtype=torch.float32, device=dev)
    lse = torch.empty_like(loss)
    es = logits.element_size()
    vec = next(w for w in (8, 4, 2, 1) if w * es <= 16 and v % w == 0
               and logits.data_ptr() % (w * es) == 0)
    _build.launch(_build.load("softmax_xent", _SIGNATURES),
                  "pt_softmax_xent", NAME, dev, logits.data_ptr(),
                  labels.data_ptr(), int(labels.dtype == torch.int64),
                  loss.data_ptr(), lse.data_ptr(), n, v,
                  _DTYPE_CODES[logits.dtype], vec, count=n > 0)
    return loss, lse
