"""Fused matmul + bias + activation: the CUDA kernel's wrapper, its plain
PyTorch version, its gradient and the static ``fused_matmul`` op's dispatch.

Port of the fp half of ``paddle_tpu/ops/pallas/matmul.py``: the Pallas
``_fmm_kernel`` (dequant=False) under the ``jax.custom_vjp`` ``_fmm_fp``, and
``try_fused_matmul``, which the static graph's ``fused_matmul`` op calls. The
kernel is ``csrc/fused_matmul.cu``: act(x @ w + bias) with fp32 accumulation
and an fp32 result, for act in {None, relu, sigmoid, tanh}, on the tensor
cores in TF32 with each fp32 operand split into hi and lo parts, so that
the products keep fp32 accuracy (the source's header); gelu (exact erf)
runs outside it on the fp32 result, so the backward keeps the
pre-activation, as matmul.py:151-159 does. CPU tensors take
:func:`_fused_matmul_reference`, the same arithmetic in plain PyTorch. The
backward (:class:`_FusedMatmulFunction`, after ``_fmm_fp_bwd``,
matmul.py:173-197) is plain PyTorch on either device: the activation's
derivative from the saved residual, then two matmuls, as the JAX package
leaves them to two stock dots.

The int8 half (``dequant=True``, ``fused_matmul_int8_pallas``,
matmul.py:232-245) is :func:`fused_matmul_int8`, forward only (serving never
differentiates a quantized program): act(x @ (w_int8 * scale / 127) + bias)
on the same tensor-core kernel, which reads the int8 weight as bytes,
converts it to fp32 (exact in TF32, so it has no lo part: two TF32 passes
for fp32 x, one for bf16 x) and applies the per-column scale to the fp32 sum
in the epilogue, so the fp32 weight never exists in device memory. CPU
tensors take :func:`_fused_matmul_int8_reference`, which dequantizes the
whole weight first, as the JAX package's stock body does.
"""

import ctypes
import math

import torch

from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.ops.kernels import _build, registry

__all__ = ["fused_matmul", "fused_matmul_int8", "try_fused_matmul"]

NAME = "fused_matmul"
INT8 = "fused_matmul_int8"
#: int8 per-channel abs-max bins: w = q * scale / 127 (opt_passes.QUANT_BINS)
_QUANT_BINS = 127.0
#: activations the kernel applies in its epilogue
_KERNEL_ACTS = {None: 0, "relu": 1, "sigmoid": 2, "tanh": 3}
_ACTS = ("relu", "sigmoid", "tanh", "gelu")
_BF16 = {torch.float32: 0, torch.bfloat16: 1}
#: rows both entries take: 65535 blocks of 64 rows (CUDA's grid y limit)
_MAX_ROWS = 65535 * 64
_SIGNATURES = {
    "pt_fused_matmul": [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                        ctypes.c_int, ctypes.c_void_p],
    "pt_fused_matmul_int8": [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                             ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                             ctypes.c_int64, ctypes.c_int, ctypes.c_void_p],
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
    _build.require_cuda(NAME, "x", x2)
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
    _check_rows(NAME, m)
    # contiguous tensors go as they are: the kernel masks every edge, so no
    # shape (word2vec's N = 2073, the MLP's N = 10, K = 70) is padded
    x2, w = x2.contiguous(), w.contiguous()
    out = torch.empty(m, n, dtype=torch.float32, device=dev)
    lib = _build.load("fused_matmul", _SIGNATURES)
    _build.launch(lib, "pt_fused_matmul", NAME, dev,
            x2.data_ptr(), _BF16[x2.dtype], w.data_ptr(), _BF16[w.dtype],
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            m, n, k, _KERNEL_ACTS[act])
    return out


def _check_rows(name, m):
    if m > _MAX_ROWS:
        raise EnforceNotMet(f"{name}: the kernel takes at most {_MAX_ROWS} "
                            f"rows of x, got {m}")


def fused_matmul_int8(x, w, scale, bias=None, act=None):
    """act(x @ (w * scale / 127) + bias) for x [..., K] (float), w int8
    [K, N], scale fp32 [N] (each column's abs-max), bias [N] or None, act as
    :func:`fused_matmul`; summed in fp32 and returned as [..., N] in
    ``promote(x.dtype, float32)``. Forward only. CPU tensors take the plain
    body; CUDA tensors launch the kernel or raise."""
    if act not in _KERNEL_ACTS and act != "gelu":
        raise EnforceNotMet(f"{INT8}: act must be one of {_ACTS} or None, "
                            f"got {act!r}")
    lead = x.shape[:-1]
    z = registry.dispatch(INT8, x.reshape(-1, x.shape[-1]), w, scale, bias,
                          None if act == "gelu" else act)
    if act == "gelu":
        z = _activate(z, "gelu")
    return z.to(torch.promote_types(x.dtype, torch.float32)).reshape(
        *lead, w.shape[1])


def _fused_matmul_int8_reference(x2, w, scale, bias=None, act=None):
    """The stock composition (``fused_matmul_int8_reference``,
    matmul.py:248-259): the whole fp32 weight first, then the matmul chain;
    fp32 [M, N]."""
    z = x2.float() @ (w.float() * (scale.float() / _QUANT_BINS))
    if bias is not None:
        z = z + bias.float()
    return _activate(z, act)


def _fused_matmul_int8_cuda(x2, w, scale, bias=None, act=None):
    """Launch the int8 entry of ``csrc/fused_matmul.cu`` on the current
    stream (no sync)."""
    dev = x2.device
    _build.require_cuda(INT8, "x", x2)
    if act not in _KERNEL_ACTS:
        raise EnforceNotMet(f"{INT8}: the kernel applies relu, sigmoid, "
                            f"tanh or nothing, got {act!r}")
    if x2.dtype not in _BF16 or x2.dim() != 2:
        raise EnforceNotMet(f"{INT8}: x must be a 2-D float32 or bfloat16 "
                            f"tensor, got {x2.dtype} {tuple(x2.shape)}")
    m, k = x2.shape
    if w.dtype != torch.int8 or w.dim() != 2 or w.shape[0] != k \
            or w.device != dev:
        raise EnforceNotMet(
            f"{INT8}: w must be an int8 [{k}, N] tensor on {dev}, got "
            f"{w.dtype} {tuple(w.shape)} on {w.device}")
    n = w.shape[1]
    if scale is None:
        raise EnforceNotMet(f"{INT8}: the kernel needs a scale table")
    for nm, t in (("scale", scale), ("bias", bias)):
        if t is not None and (t.device != dev or tuple(t.shape) != (n,)):
            raise EnforceNotMet(f"{INT8}: {nm} must be [{n}] on {dev}, got "
                                f"{tuple(t.shape)} on {t.device}")
    # the kernel reads an fp32 scale and bias
    scale = scale.to(torch.float32).contiguous()
    if bias is not None:
        bias = bias.to(torch.float32).contiguous()
    _check_rows(INT8, m)
    x2, w = x2.contiguous(), w.contiguous()
    out = torch.empty(m, n, dtype=torch.float32, device=dev)
    lib = _build.load("fused_matmul", _SIGNATURES)
    _build.launch(lib, "pt_fused_matmul_int8", INT8, dev,
            x2.data_ptr(), _BF16[x2.dtype], w.data_ptr(), scale.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            m, n, k, _KERNEL_ACTS[act])
    return out


def try_fused_matmul(ins, attrs):
    """The kernels' path for the static ``fused_matmul`` op (``quant``
    None, "bf16" or "int8"), with the contract checks of
    matmul.py:273-340: the output, or None when the
    operands fall outside the kernel's contract (then the caller runs the
    plain composition, as the JAX package does). Inside the contract a CUDA
    tensor always launches the kernel or raises. One difference: a ``mul``
    takes x of any rank, flattened at ``x_num_col_dims`` as the op
    flattens it, the output's leading dims restored after (the JAX contract
    refuses an x whose last dim is not w's first, so an fc over a conv's
    [B, C, H, W] output ran the composition there; an fc with
    ``num_flatten_dims=2`` over [B, T, D] has D last and takes the kernel
    in both)."""
    xs = list(ins["X"])
    x, w = xs[0], xs[1]
    quant = attrs.get("quant")
    i = 2
    scale = None
    if quant == "int8":
        scale = xs[i]
        i += 1
        if w.dtype != torch.int8:
            return None
    elif quant not in (None, "bf16"):
        return None
    if w.dim() != 2 or x.dim() < 2:
        return None
    if not x.is_floating_point() or (quant != "int8"
                                     and not w.is_floating_point()):
        return None
    mm_attrs = attrs.get("mm_attrs", {})
    if attrs["mm_type"] == "matmul":
        if mm_attrs.get("transpose_x") or mm_attrs.get("transpose_y") \
                or mm_attrs.get("alpha", 1.0) != 1.0 \
                or x.shape[-1] != w.shape[0]:
            return None
        x_eff = x
        out_shape = (*x.shape[:-1], w.shape[1])
    elif attrs["mm_type"] == "mul":
        k = mm_attrs.get("x_num_col_dims", 1)
        if not 1 <= k < x.dim() or mm_attrs.get("y_num_col_dims", 1) != 1:
            return None
        x_eff = x.reshape(math.prod(x.shape[:k]), -1)
        if x_eff.shape[1] != w.shape[0]:
            return None
        out_shape = (*x.shape[:k], w.shape[1])
    else:
        return None
    bias = None
    if attrs.get("has_bias"):
        b = xs[i]
        axis = attrs.get("bias_axis", -1)
        if b.dim() != 1 or b.shape[0] != w.shape[1] \
                or axis not in (-1, len(out_shape) - 1):
            return None
        bias = b
    act = attrs.get("act")
    if act is not None and act not in _ACTS:
        return None
    if quant == "int8":
        out = fused_matmul_int8(x_eff, w, scale, bias=bias, act=act)
    else:
        # bf16 storage: the stock path casts the weight to fp32 first, so
        # the result is fp32 whatever the weight's dtype
        out = fused_matmul(x_eff, w, bias=bias, act=act, out_dtype=(
            torch.promote_types(x.dtype, torch.float32) if quant else None))
    return out.reshape(out_shape)
