"""Fused Adam: the CUDA kernel's wrapper and its plain PyTorch version.

Port of the Adam part of ``paddle_tpu/ops/pallas/optimizer.py``
(``fused_adam_reference`` and the Pallas ``_adam_kernel`` behind
``fused_adam_pallas``). The port updates a whole list of fp32 tensors in
place with one launch of ``csrc/fused_adam.cu``, where the JAX package runs
one Pallas call per tensor and returns new arrays; CPU tensors take
:func:`_fused_adam_reference`, the JAX reference applied per tensor.
"""

import ctypes
import itertools

import torch

from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.ops.kernels import _build, registry

__all__ = ["fused_adam"]

NAME = "fused_adam"
_CHUNK = 16384        # elements per block; csrc/fused_adam.cu's kChunk
_P = ctypes.c_void_p
_F = ctypes.c_float
_SIGNATURES = {
    "pt_fused_adam": [_P, _P, ctypes.c_int, ctypes.c_int64, _P] + [_F] * 6
    + [_P],
}


def fused_adam(params, grads, m1s, m2s, lr, step, beta1=0.9, beta2=0.999,
               epsilon=1e-8):
    """Bias-corrected Adam over lists of fp32 tensors, in place:
    m1 = b1 m1 + (1-b1) g, m2 = b2 m2 + (1-b2) g^2 and
    p -= lr * sqrt(1-b2^t) / (1-b1^t) * m1 / (sqrt(m2) + eps), with t the
    int32 0-d tensor ``step`` (already incremented for this update).
    ``lr`` is a float. Returns None.

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
    dev = params[0].device
    if dev.type != "cuda":
        raise EnforceNotMet(f"{NAME}: the kernel takes CUDA tensors, got "
                            f"params on {dev}")
    if not len(params) == len(grads) == len(m1s) == len(m2s):
        raise EnforceNotMet(
            f"{NAME}: params, grads, m1s and m2s must be lists of one "
            f"length, got {len(params)}, {len(grads)}, {len(m1s)}, "
            f"{len(m2s)}")
    if (not isinstance(step, torch.Tensor) or step.device != dev
            or step.dtype != torch.int32 or step.dim() != 0):
        raise EnforceNotMet(f"{NAME}: step must be a 0-d int32 tensor on "
                            f"{dev}")
    rows, keep = [], []
    for i, (p, g, m1, m2) in enumerate(zip(params, grads, m1s, m2s)):
        for nm, t in (("param", p), ("grad", g), ("moment1", m1),
                      ("moment2", m2)):
            if (t.device != dev or t.dtype != torch.float32
                    or t.shape != p.shape):
                raise EnforceNotMet(
                    f"{NAME}: {nm} {i} must be a float32 tensor of shape "
                    f"{tuple(p.shape)} on {dev}, got {t.dtype} "
                    f"{tuple(t.shape)} on {t.device}")
            if nm != "grad" and not t.is_contiguous():
                raise EnforceNotMet(f"{NAME}: {nm} {i} is updated in place "
                                    "and must be contiguous")
        # a contiguous copy must outlive the launch's queueing: the table's
        # own allocation below could otherwise take its memory
        g = g.contiguous()
        keep.append(g)
        rows.append((p.data_ptr(), g.data_ptr(), m1.data_ptr(),
                     m2.data_ptr(), p.numel()))
    starts = list(itertools.accumulate(
        (-(-r[4] // _CHUNK) for r in rows), initial=0))
    # the table reaches the card by an asynchronous copy from pinned
    # memory: no sync per step (the grads' pointers change every step)
    host = torch.tensor([v for r in rows for v in r] + starts,
                        dtype=torch.int64).pin_memory()
    table = host.to(dev, non_blocking=True)
    lib = _build.load("fused_adam", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pt_fused_adam(
            table.data_ptr(), table.data_ptr() + 8 * 5 * len(rows),
            len(rows), starts[-1], step.data_ptr(), float(lr),
            float(beta1), float(1 - beta1), float(beta2), float(1 - beta2),
            float(epsilon), stream)
    _build.check_launch(lib, NAME, err)
    registry.get_kernel(NAME).count_launch()
