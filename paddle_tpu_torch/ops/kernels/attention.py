"""Flash-attention forward: the CUDA kernel's wrapper and its plain version.

Port of ``paddle_tpu/ops/pallas_kernels.py`` ``flash_attention`` (the Pallas
forward ``_flash_fwd_kernel`` behind the padding wrapper
``_flash_attention_pallas``). The kernel is ``csrc/flash_attention_fwd.cu``;
CPU tensors take :func:`_dense_attention_reference`, the port of the JAX
package's ``_dense_attention_reference``. The backward kernels come with
the training slice.
"""

import ctypes
import math

import torch

from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.ops.kernels import _build, registry

__all__ = ["flash_attention"]

NAME = "flash_attention"
_NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64)
_SIGNATURES = {
    "pt_flash_attention_fwd": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
    + [ctypes.c_int64] * 9 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p],
}


def flash_attention(q, k, v, bias=None, causal=False, sm_scale=None,
                    return_lse=False):
    """Blockwise (flash) attention forward.

    q, k, v: [B, H, S, D]. bias: optional additive key bias with B*S
    elements ([B, S], e.g. a key-padding mask of 0 / -1e9). ``sm_scale``
    defaults to 1/sqrt(D). Returns o [B, H, S, D] in q's dtype, or
    (o, lse) with lse [B, H, S] fp32 when ``return_lse``.

    CPU tensors take the plain PyTorch body; CUDA tensors launch the kernel
    or raise."""
    return registry.dispatch(NAME, q, k, v, bias=bias, causal=causal,
                             sm_scale=sm_scale, return_lse=return_lse)


def _dense_attention_reference(q, k, v, bias=None, causal=False,
                               sm_scale=None, return_lse=False):
    """Plain PyTorch attention with the [S, S] scores materialized: the
    semantic reference the kernel is held against."""
    b, h, s, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    qs = q.float() * sm_scale
    scores = torch.einsum("bhqd,bhkd->bhqk", qs, k.float())
    if bias is not None:
        scores = scores + bias.float().reshape(b, s)[:, None, None, :]
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~keep, _NEG_INF)
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
    if return_lse:
        return o, torch.logsumexp(scores, dim=-1)
    return o


def _flash_attention_cuda(q, k, v, bias=None, causal=False, sm_scale=None,
                          return_lse=False):
    """Launch ``csrc/flash_attention_fwd.cu`` on the current stream (no
    sync). q/k/v may be strided views (e.g. heads split out of a fused
    [B, S, 3*N*D] projection) as long as the last axis is unit-stride."""
    if q.dim() != 4:
        raise EnforceNotMet(f"{NAME}: q must be [B, H, S, D], got shape "
                            f"{tuple(q.shape)}")
    b, h, s, d = q.shape
    for nm, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise EnforceNotMet(f"{NAME}: {nm} must be on the CUDA device of "
                                f"q ({q.device}), got {t.device}")
        if t.dtype != q.dtype or t.dtype not in _DTYPE_CODES:
            raise EnforceNotMet(f"{NAME}: q, k, v must all be float32 or all "
                                f"bfloat16, got {nm} {t.dtype} with q "
                                f"{q.dtype}")
        if tuple(t.shape) != (b, h, s, d) or t.stride(-1) != 1:
            raise EnforceNotMet(
                f"{NAME}: {nm} must be [B, H, S, D] = {(b, h, s, d)} with a "
                f"unit-stride last axis, got {tuple(t.shape)} strides "
                f"{t.stride()}")
    if d not in _HEAD_DIMS:
        raise EnforceNotMet(f"{NAME}: the kernel takes head_dim in "
                            f"{_HEAD_DIMS}, got {d}")
    if b * h > 65535:
        raise EnforceNotMet(f"{NAME}: the kernel takes B*H <= 65535, got "
                            f"{b * h}")
    if bias is not None:
        if bias.device != q.device or bias.numel() != b * s:
            raise EnforceNotMet(
                f"{NAME}: bias must hold B*S = {b * s} elements on "
                f"{q.device}, got {tuple(bias.shape)} on {bias.device}")
        bias = bias.to(torch.float32).reshape(b, s).contiguous()
    _build.require_no_grad(NAME, q, k, v,
                           *(() if bias is None else (bias,)))
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    o = torch.empty((b, h, s, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    lib = _build.load("flash_attention_fwd", _SIGNATURES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.pt_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(),
            o.data_ptr(), lse.data_ptr(), b, h, s, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            float(sm_scale), int(bool(causal)), _DTYPE_CODES[q.dtype],
            stream)
    _build.check_launch(lib, NAME, err)
    registry.get_kernel(NAME).count_launch()
    if return_lse:
        return o, lse
    return o
