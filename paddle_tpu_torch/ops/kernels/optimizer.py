"""Fused optimizer updates: the CUDA kernels' wrappers and their plain
PyTorch versions.

Port of ``paddle_tpu/ops/pallas/optimizer.py``: Adam (``fused_adam_reference``
and the Pallas ``_adam_kernel``), SGD (``_sgd_kernel``) and momentum
(``_momentum_kernel``). The port updates a whole list of fp32 tensors in
place with one launch (``csrc/fused_adam.cu``, ``csrc/fused_sgd.cu``), where
the JAX package runs one Pallas call per tensor and returns new arrays; CPU
tensors take the plain bodies, the JAX references applied per tensor in the
same order of operations.

The launch harness is shared: the host writes a table of pointers and
element counts per tensor, the prefix sum of each tensor's 16K-element
chunks and any scalars the card reads, to pinned memory, and copies it to
the card asynchronously (no sync per step; the grads' pointers change every
step). A block finds its tensor by binary search in the prefix sum.
"""

import ctypes
import itertools
import struct

import torch

from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.ops.kernels import _build, registry

__all__ = ["fused_adam", "fused_sgd", "fused_momentum"]

NAME = "fused_adam"
SGD = "fused_sgd"
MOMENTUM = "fused_momentum"
_CHUNK = 16384        # elements per block; kChunk of both sources
_P = ctypes.c_void_p
_F = ctypes.c_float
_SIGNATURES = {
    "pt_fused_adam": [_P, _P, ctypes.c_int, ctypes.c_int64, _P, _P]
    + [_F] * 5 + [_P],
}
_SGD_SIGNATURES = {
    "pt_fused_sgd": [_P, _P, ctypes.c_int, ctypes.c_int64, _P, _P],
    "pt_fused_momentum": [_P, _P, ctypes.c_int, ctypes.c_int64, _P, _F,
                          ctypes.c_int, _P],
}


def fused_adam(params, grads, m1s, m2s, lr, step, beta1=0.9, beta2=0.999,
               epsilon=1e-8):
    """Bias-corrected Adam over lists of fp32 tensors, in place:
    m1 = b1 m1 + (1-b1) g, m2 = b2 m2 + (1-b2) g^2 and
    p -= lr * sqrt(1-b2^t) / (1-b1^t) * m1 / (sqrt(m2) + eps), with t the
    int32 0-d tensor ``step`` (already incremented for this update).
    ``lr`` is a float or a 0-d fp32 tensor on the params' device. Returns
    None.

    CPU tensors take the plain PyTorch body; CUDA tensors launch the kernel
    (once for the whole list) or raise."""
    if not params:
        return None
    body = registry.selected_body(NAME, params[0].device)
    return registry.get_body(NAME, body)(
        params, grads, m1s, m2s, lr, step, beta1=beta1, beta2=beta2,
        epsilon=epsilon)


def _fused_adam_reference(params, grads, m1s, m2s, lr, step, beta1=0.9,
                          beta2=0.999, epsilon=1e-8):
    """``fused_adam_reference`` (pallas/optimizer.py:128-135) per tensor,
    written back in place."""
    t = step.float()
    bc = torch.sqrt(1 - beta2 ** t) / (1 - beta1 ** t)
    for p, g, m1, m2 in zip(params, grads, m1s, m2s, strict=True):
        m1n = beta1 * m1 + (1 - beta1) * g
        m2n = beta2 * m2 + (1 - beta2) * torch.square(g)
        p.copy_(p - lr * bc * m1n / (torch.sqrt(m2n) + epsilon))
        m1.copy_(m1n)
        m2.copy_(m2n)


def _fused_adam_cuda(params, grads, m1s, m2s, lr, step, beta1=0.9,
                     beta2=0.999, epsilon=1e-8):
    """Launch ``csrc/fused_adam.cu`` once over the list on the current
    stream (no sync). p, m1, m2 must be contiguous fp32 CUDA tensors on one
    device; a grad that is not contiguous is copied first."""
    dev = _cuda_device(NAME, params)
    if (not isinstance(step, torch.Tensor) or step.device != dev
            or step.dtype != torch.int32 or step.dim() != 0):
        raise EnforceNotMet(f"{NAME}: step must be a 0-d int32 tensor on "
                            f"{dev}")
    rows = _rows(NAME, dev, params, grads, m1s, m2s,
                 names=("param", "grad", "moment1", "moment2"))
    lr_ptr, words = _lr_arg(NAME, lr, dev)
    table, starts, n_chunks = _table(dev, rows, words)
    _build.launch(_build.load("fused_adam", _SIGNATURES), "pt_fused_adam",
                  NAME, dev, table.data_ptr(), starts, len(rows), n_chunks,
                  step.data_ptr(), lr_ptr or starts + 8 * (len(rows) + 1),
                  float(beta1), float(1 - beta1), float(beta2),
                  float(1 - beta2), float(epsilon))


def _lr_arg(name, lr, dev):
    """(device address of the rate, table words): a 0-d fp32 tensor on
    ``dev`` is read where it lies (no words); a float travels as the
    table's last word (address None: the caller points past the prefix
    sums)."""
    if not isinstance(lr, torch.Tensor):
        return None, [_f32_word(lr)]
    if lr.device != dev or lr.dtype != torch.float32 or lr.dim() != 0:
        raise EnforceNotMet(f"{name}: lr must be a float or a 0-d float32 "
                            f"tensor on {dev}, got {lr.dtype} "
                            f"{tuple(lr.shape)} on {lr.device}")
    return lr.data_ptr(), []


def _rows(name, dev, params, *others, names):
    """The table rows {p, g, [slots...], n} of the launch, after checking
    that the lists have one length, every tensor is fp32 of its param's
    shape on ``dev`` and the ones updated in place are contiguous. A grad
    that is not contiguous is copied first."""
    for nm, ts in zip(names[1:], others):
        if len(ts) != len(params):
            raise EnforceNotMet(
                f"{name}: {names[0]}s and {nm}s must be lists of one length, "
                f"got {len(params)} and {len(ts)}")
    rows = []
    for i, ts in enumerate(zip(params, *others)):
        p = ts[0]
        for nm, t in zip(names, ts):
            if (t.device != dev or t.dtype != torch.float32
                    or t.shape != p.shape):
                raise EnforceNotMet(
                    f"{name}: {nm} {i} must be a float32 tensor of shape "
                    f"{tuple(p.shape)} on {dev}, got {t.dtype} "
                    f"{tuple(t.shape)} on {t.device}")
            if nm != "grad" and not t.is_contiguous():
                raise EnforceNotMet(f"{name}: {nm} {i} is updated in place "
                                    "and must be contiguous")
        g = ts[1].contiguous()
        rows.append((p, g, *ts[2:]))
    return rows


def _table(dev, rows, scalars=()):
    """Copy the launch table to the card: ``rows`` of tensors become
    {pointers..., n}, then the chunk prefix sums, then ``scalars`` (each an
    int64 word). Returns (table, device address of the prefix sums, number
    of chunks). The caller holds ``rows`` until the launch is queued: a
    grad's contiguous copy must outlive it, or the table's own allocation
    could take its memory."""
    counts = [-(-r[0].numel() // _CHUNK) for r in rows]
    starts = list(itertools.accumulate(counts, initial=0))
    words = [w for r in rows for w in
             (*(t.data_ptr() for t in r), r[0].numel())]
    host = torch.tensor(words + starts + list(scalars),
                        dtype=torch.int64).pin_memory()
    table = host.to(dev, non_blocking=True)
    return table, table.data_ptr() + 8 * len(words), starts[-1]


def _f32_word(x):
    """The bits of float32(x) as an int64 table word."""
    return struct.unpack("<i", struct.pack("<f", float(x)))[0]


def fused_sgd(params, grads, lr):
    """SGD over lists of fp32 tensors, in place: p -= lr * g, with ``lr`` a
    float (rounded to fp32, as the JAX package's f32 learning rate is) or a
    0-d fp32 tensor on the params' device.
    Returns None. CPU tensors take the plain PyTorch body; CUDA tensors
    launch the kernel (once for the whole list) or raise."""
    if not params:
        return None
    body = registry.selected_body(SGD, params[0].device)
    return registry.get_body(SGD, body)(params, grads, lr)


def fused_momentum(params, grads, velocities, lr, momentum=0.9,
                   use_nesterov=False):
    """Momentum over lists of fp32 tensors, in place: v = momentum * v + g,
    then p -= lr * v, or p -= lr * (g + momentum * v) with ``use_nesterov``;
    ``lr`` as for :func:`fused_sgd`. Returns None. CPU tensors take the plain PyTorch body; CUDA tensors
    launch the kernel (once for the whole list) or raise."""
    if not params:
        return None
    body = registry.selected_body(MOMENTUM, params[0].device)
    return registry.get_body(MOMENTUM, body)(
        params, grads, velocities, lr, momentum=momentum,
        use_nesterov=use_nesterov)


def _fused_sgd_reference(params, grads, lr):
    """``fused_sgd_reference`` (pallas/optimizer.py:79-80) per tensor,
    written back in place."""
    lr = _f32(lr)
    for p, g in zip(params, grads, strict=True):
        p.copy_(p - lr * g)


def _fused_momentum_reference(params, grads, velocities, lr, momentum=0.9,
                              use_nesterov=False):
    """``fused_momentum_reference`` (pallas/optimizer.py:95-102) per
    tensor, written back in place."""
    lr, momentum = _f32(lr), _f32(momentum)
    for p, g, v in zip(params, grads, velocities, strict=True):
        vn = momentum * v + g
        if use_nesterov:
            p.copy_(p - lr * (g + momentum * vn))
        else:
            p.copy_(p - lr * vn)
        v.copy_(vn)


def _f32(x):
    """float32(x) as a Python float, the scalar the kernels read; a tensor
    (a scheduled rate, already fp32) as it is."""
    if isinstance(x, torch.Tensor):
        return x
    return struct.unpack("<f", struct.pack("<f", float(x)))[0]


def _fused_sgd_cuda(params, grads, lr):
    """Launch ``csrc/fused_sgd.cu``'s SGD once over the list on the current
    stream (no sync); a float lr travels in the launch table."""
    dev = _cuda_device(SGD, params)
    rows = _rows(SGD, dev, params, grads, names=("param", "grad"))
    lr_ptr, words = _lr_arg(SGD, lr, dev)
    table, starts, n_chunks = _table(dev, rows, words)
    _build.launch(_build.load("fused_sgd", _SGD_SIGNATURES), "pt_fused_sgd",
                  SGD, dev, table.data_ptr(), starts, len(rows), n_chunks,
                  lr_ptr or starts + 8 * (len(rows) + 1))


def _fused_momentum_cuda(params, grads, velocities, lr, momentum=0.9,
                         use_nesterov=False):
    """Launch ``csrc/fused_sgd.cu``'s momentum once over the list on the
    current stream (no sync); a float lr travels in the launch table."""
    dev = _cuda_device(MOMENTUM, params)
    rows = _rows(MOMENTUM, dev, params, grads, velocities,
                 names=("param", "grad", "velocity"))
    lr_ptr, words = _lr_arg(MOMENTUM, lr, dev)
    table, starts, n_chunks = _table(dev, rows, words)
    _build.launch(_build.load("fused_sgd", _SGD_SIGNATURES),
                  "pt_fused_momentum", MOMENTUM, dev, table.data_ptr(),
                  starts, len(rows), n_chunks,
                  lr_ptr or starts + 8 * (len(rows) + 1),
                  _f32(momentum), int(bool(use_nesterov)))


def _cuda_device(name, params):
    _build.require_cuda(name, "params", params[0])
    return params[0].device
