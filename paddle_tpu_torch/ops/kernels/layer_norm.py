"""Row LayerNorm: the CUDA kernel's wrapper, its plain PyTorch version and
its gradient.

Port of ``paddle_tpu/ops/pallas_kernels.py`` ``fused_layer_norm`` (the Pallas
forward ``_ln_fwd_kernel`` under the ``jax.custom_vjp`` whose backward is
``_fused_ln_bwd``). Statistics are fp32 (two-pass centred variance), the
output is in x's dtype. The kernel is ``csrc/layer_norm.cu``; CPU tensors
take :func:`_layer_norm_reference`. When an input requires grad the call
goes through :class:`_LayerNormFunction`, whose forward dispatches the same
body and whose backward is the plain PyTorch port of ``_fused_ln_bwd`` on
either device (the JAX package has no kernel for it either).
"""

import ctypes

import torch

from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.ops.kernels import _build, registry

__all__ = ["fused_layer_norm"]

NAME = "fused_layer_norm"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: widest row the kernel keeps in registers: 32 lanes x 8 vectors of 16 B
_MAX_HIDDEN = {torch.float32: 1024, torch.bfloat16: 2048}
_SIGNATURES = {
    "pt_layer_norm_fwd": [ctypes.c_void_p] * 6 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p],
}


def fused_layer_norm(x, gamma, beta, eps=1e-12, return_stats=False):
    """LayerNorm over the last axis of ``x`` [..., H] with fp32 statistics;
    ``gamma``/``beta`` [H]. Returns y in x's dtype, or (y, mu, rstd) with
    fp32 mu and rstd of shape x.shape[:-1] when ``return_stats``.

    CPU tensors take the plain PyTorch body; CUDA tensors launch the
    kernel or raise. Differentiable in x, gamma and beta."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, gamma, beta)):
        y, mu, rstd = _LayerNormFunction.apply(x, gamma, beta, eps)
        return (y, mu, rstd) if return_stats else y
    return registry.dispatch(NAME, x, gamma, beta, eps=eps,
                             return_stats=return_stats)


class _LayerNormFunction(torch.autograd.Function):
    """Forward: the registered body with its statistics saved. Backward:
    ``_fused_ln_bwd`` (pallas_kernels.py:496-508) in fp32, cast back to the
    dtypes of x and gamma."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        y, mu, rstd = registry.dispatch(NAME, x, gamma, beta, eps=eps,
                                        return_stats=True)
        ctx.save_for_backward(x, gamma, mu, rstd)
        ctx.mark_non_differentiable(mu, rstd)
        return y, mu, rstd

    @staticmethod
    def backward(ctx, dy, _dmu, _drstd):
        x, gamma, mu, rstd = ctx.saved_tensors
        h = x.shape[-1]
        x32 = x.reshape(-1, h).float()
        dy32 = dy.reshape(-1, h).float()
        mu, rstd = mu.reshape(-1, 1), rstd.reshape(-1, 1)
        xhat = (x32 - mu) * rstd
        dg = (dy32 * xhat).sum(0)
        db = dy32.sum(0)
        wdy = dy32 * gamma.float()
        c1 = wdy.mean(-1, keepdim=True)
        c2 = (wdy * xhat).mean(-1, keepdim=True)
        dx = (wdy - c1 - xhat * c2) * rstd
        return (dx.reshape(x.shape).to(x.dtype), dg.to(gamma.dtype),
                db.to(gamma.dtype), None)


def _layer_norm_reference(x, gamma, beta, eps=1e-12, return_stats=False):
    """Plain PyTorch LayerNorm with the math of the TPU kernel."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = ((x32 - mu) * rstd * gamma.float() + beta.float()).to(x.dtype)
    if return_stats:
        return y, mu[..., 0], rstd[..., 0]
    return y


def _layer_norm_cuda(x, gamma, beta, eps=1e-12, return_stats=False):
    """Launch ``csrc/layer_norm.cu`` on the current stream (no sync)."""
    _build.require_cuda(NAME, "x", x)
    if x.dtype not in _DTYPE_CODES:
        raise EnforceNotMet(f"{NAME}: x must be float32 or bfloat16, got "
                            f"{x.dtype}")
    if x.dim() < 1 or not x.is_contiguous():
        raise EnforceNotMet(f"{NAME}: x must be a contiguous tensor of rank "
                            f">= 1, got shape {tuple(x.shape)} strides "
                            f"{x.stride()}")
    h = x.shape[-1]
    vec = 16 // x.element_size()
    if h % vec or h > _MAX_HIDDEN[x.dtype]:
        raise EnforceNotMet(
            f"{NAME}: the kernel takes a last axis that is a multiple of "
            f"{vec} and at most {_MAX_HIDDEN[x.dtype]} for {x.dtype}, got "
            f"{h}")
    for nm, t in (("gamma", gamma), ("beta", beta)):
        if t.device != x.device or tuple(t.shape) != (h,):
            raise EnforceNotMet(
                f"{NAME}: {nm} must be [{h}] on {x.device}, got "
                f"{tuple(t.shape)} on {t.device}")
    # the kernel reads fp32 affine parameters
    gamma = gamma.to(torch.float32).contiguous()
    beta = beta.to(torch.float32).contiguous()
    for nm, t in (("x", x), ("gamma", gamma), ("beta", beta)):
        if t.data_ptr() % 16:
            raise EnforceNotMet(f"{NAME}: {nm} must be 16-byte aligned for "
                                "the kernel's vector loads")
    n = x.numel() // h
    y = torch.empty_like(x)
    mu = rstd = None
    if return_stats:
        mu = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
        rstd = torch.empty_like(mu)
    _build.launch(_build.load("layer_norm", _SIGNATURES), "pt_layer_norm_fwd",
                  NAME, x.device, x.data_ptr(), gamma.data_ptr(),
                  beta.data_ptr(), y.data_ptr(),
                  None if mu is None else mu.data_ptr(),
                  None if rstd is None else rstd.data_ptr(),
                  n, h, float(eps), _DTYPE_CODES[x.dtype])
    if return_stats:
        return y, mu, rstd
    return y
