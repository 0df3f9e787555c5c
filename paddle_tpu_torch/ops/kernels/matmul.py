"""Fused matmul + bias + activation: the CUDA kernel's wrapper, its plain
PyTorch version, its gradient and the static ``fused_matmul`` op's dispatch.

Port of the fp half of ``paddle_tpu/ops/pallas/matmul.py``: the Pallas
``_fmm_kernel`` (dequant=False) under the ``jax.custom_vjp`` ``_fmm_fp``, and
``try_fused_matmul``, which the static graph's ``fused_matmul`` op calls. The
kernel is ``csrc/fused_matmul.cu``: act(x @ w + bias) with fp32 accumulation
and an fp32 result, for act in {None, relu, sigmoid, tanh}; gelu (exact erf)
runs outside it on the fp32 result, so the backward keeps the
pre-activation, as matmul.py:151-159 does. CPU tensors take
:func:`_fused_matmul_reference`, the same arithmetic in plain PyTorch. The
backward (:class:`_FusedMatmulFunction`, after ``_fmm_fp_bwd``,
matmul.py:173-197) is plain PyTorch on either device: the activation's
derivative from the saved residual, then two matmuls, as the JAX package
leaves them to two stock dots.

The int8 half (row 9: ``dequant=True``, PTQ serving) is not ported yet; an
op that carries ``quant`` raises.
"""

import ctypes
import math

import torch

from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.ops.kernels import _build, registry

__all__ = ["fused_matmul", "try_fused_matmul"]

NAME = "fused_matmul"
#: activations the kernel applies in its epilogue
_KERNEL_ACTS = {None: 0, "relu": 1, "sigmoid": 2, "tanh": 3}
_ACTS = ("relu", "sigmoid", "tanh", "gelu")
_BF16 = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    "pt_fused_matmul": [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                        ctypes.c_int, ctypes.c_void_p],
}


def _activate(z, act):
    """The epilogue activations on fp32, as ops/activation.py has them."""
    if act == "relu":
        return torch.relu(z)
    if act == "sigmoid":
        return torch.sigmoid(z)
    if act == "tanh":
        return torch.tanh(z)
    if act == "gelu":
        return torch.nn.functional.gelu(z)
    return z


def fused_matmul(x, w, bias=None, act=None, out_dtype=None):
    """act(x @ w + bias) for x [..., K], w [K, N], bias [N] or None, act in
    (None, "relu", "sigmoid", "tanh", "gelu"), summed in fp32 and returned
    as [..., N] in ``out_dtype`` (default: the promotion of x's and w's
    dtypes). CPU tensors take the plain PyTorch body; CUDA tensors launch
    the kernel or raise. Differentiable in x, w and bias."""
    if act not in _KERNEL_ACTS and act != "gelu":
        raise EnforceNotMet(f"{NAME}: act must be one of {_ACTS} or None, "
                            f"got {act!r}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if out_dtype is None:
        out_dtype = torch.promote_types(x.dtype, w.dtype)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x2, w, bias)):
        out = _FusedMatmulFunction.apply(x2, w, bias, act, out_dtype)
    else:
        out = _forward(x2, w, bias, act)[0].to(out_dtype)
    return out.reshape(*lead, w.shape[1])


def _forward(x2, w, bias, act):
    """(fp32 output, fp32 residual for the backward): the post-activation
    output, or the pre-activation for gelu."""
    z = registry.dispatch(NAME, x2, w, bias,
                          None if act == "gelu" else act)
    if act == "gelu":
        return _activate(z, "gelu"), z
    return z, z


class _FusedMatmulFunction(torch.autograd.Function):
    """Forward: the registered body (plus gelu outside it). Backward:
    ``_fmm_fp_bwd`` (matmul.py:173-197) in fp32, cast back to the dtypes of
    x, w and bias."""

    @staticmethod
    def forward(ctx, x2, w, bias, act, out_dtype):
        out, res = _forward(x2, w, bias, act)
        ctx.act = act
        ctx.save_for_backward(x2, w, bias, res)
        return out.to(out_dtype)

    @staticmethod
    def backward(ctx, dy):
        x2, w, bias, res = ctx.saved_tensors
        dy32 = dy.float()
        act = ctx.act
        if act == "relu":
            dz = dy32 * (res > 0)               # res: the post-act output
        elif act == "sigmoid":
            dz = dy32 * res * (1.0 - res)
        elif act == "tanh":
            dz = dy32 * (1.0 - res * res)
        elif act == "gelu":                     # res: the pre-act z
            cdf = 0.5 * (1.0 + torch.erf(res * (1.0 / math.sqrt(2.0))))
            pdf = torch.exp(-0.5 * res * res) * (1.0 / math.sqrt(2 * math.pi))
            dz = dy32 * (cdf + res * pdf)
        else:
            dz = dy32
        dx = (dz @ w.float().t()).to(x2.dtype)
        dw = (x2.float().t() @ dz).to(w.dtype)
        db = None if bias is None else dz.sum(0).to(bias.dtype)
        return dx, dw, db, None, None


def _fused_matmul_reference(x2, w, bias=None, act=None):
    """The kernel's arithmetic in plain PyTorch: fp32 [M, N]."""
    z = x2.float() @ w.float()
    if bias is not None:
        z = z + bias.float()
    return _activate(z, act)


def _fused_matmul_cuda(x2, w, bias=None, act=None):
    """Launch ``csrc/fused_matmul.cu`` on the current stream (no sync)."""
    dev = x2.device
    if dev.type != "cuda":
        raise EnforceNotMet(f"{NAME}: the kernel takes CUDA tensors, got x "
                            f"on {dev}")
    if act not in _KERNEL_ACTS:
        raise EnforceNotMet(f"{NAME}: the kernel applies relu, sigmoid, "
                            f"tanh or nothing, got {act!r}")
    for nm, t in (("x", x2), ("w", w)):
        if t.dtype not in _BF16 or t.dim() != 2 or t.device != dev:
            raise EnforceNotMet(
                f"{NAME}: {nm} must be a 2-D float32 or bfloat16 tensor on "
                f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    m, k = x2.shape
    if w.shape[0] != k:
        raise EnforceNotMet(f"{NAME}: x [{m}, {k}] and w {tuple(w.shape)} "
                            "do not chain")
    n = w.shape[1]
    if bias is not None:
        if bias.device != dev or tuple(bias.shape) != (n,):
            raise EnforceNotMet(f"{NAME}: bias must be [{n}] on {dev}, got "
                                f"{tuple(bias.shape)} on {bias.device}")
        # the kernel reads an fp32 bias
        bias = bias.to(torch.float32).contiguous()
    x2, w = x2.contiguous(), w.contiguous()
    out = torch.empty(m, n, dtype=torch.float32, device=dev)
    lib = _build.load("fused_matmul", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pt_fused_matmul(
            x2.data_ptr(), _BF16[x2.dtype], w.data_ptr(), _BF16[w.dtype],
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            m, n, k, _KERNEL_ACTS[act], stream)
    _build.check_launch(lib, NAME, err)
    registry.get_kernel(NAME).count_launch()
    return out


def try_fused_matmul(ins, attrs):
    """The kernel's path for the static ``fused_matmul`` op, with the
    contract checks of matmul.py:273-340: the output, or None when the
    operands fall outside the kernel's contract (then the caller runs the
    plain composition, as the JAX package does). Inside the contract a CUDA
    tensor always launches the kernel or raises."""
    xs = list(ins["X"])
    x, w = xs[0], xs[1]
    if w.dim() != 2 or x.dim() < 2 or x.shape[-1] != w.shape[0]:
        return None
    if not x.is_floating_point() or not w.is_floating_point():
        return None
    mm_attrs = attrs.get("mm_attrs", {})
    if attrs["mm_type"] == "matmul":
        if mm_attrs.get("transpose_x") or mm_attrs.get("transpose_y") \
                or mm_attrs.get("alpha", 1.0) != 1.0:
            return None
        x_eff = x
        out_shape = (*x.shape[:-1], w.shape[1])
    elif attrs["mm_type"] == "mul":
        if mm_attrs.get("x_num_col_dims", 1) != 1 \
                or mm_attrs.get("y_num_col_dims", 1) != 1:
            return None
        x_eff = x.reshape(x.shape[0], -1)
        if x_eff.shape[1] != w.shape[0]:
            return None
        out_shape = (x.shape[0], w.shape[1])
    else:
        return None
    bias = None
    if attrs.get("has_bias"):
        b = xs[2]
        axis = attrs.get("bias_axis", -1)
        if b.dim() != 1 or b.shape[0] != w.shape[1] \
                or axis not in (-1, len(out_shape) - 1):
            return None
        bias = b
    act = attrs.get("act")
    if act is not None and act not in _ACTS:
        return None
    return fused_matmul(x_eff, w, bias=bias, act=act).reshape(out_shape)
