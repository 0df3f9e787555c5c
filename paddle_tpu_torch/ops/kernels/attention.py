"""Flash attention: the CUDA kernels' wrappers, their plain versions and the
gradient that joins them.

Port of ``paddle_tpu/ops/pallas_kernels.py`` ``flash_attention``: the Pallas
forward ``_flash_fwd_kernel`` behind the padding wrapper
``_flash_attention_pallas``, and the ``jax.custom_vjp`` backward
``_flash_attention_bwd``, whose two Pallas kernels ``_flash_bwd_dkdv_kernel``
and ``_flash_bwd_dq_kernel`` recompute the probabilities from the saved
logsumexp. Three registered kernels:

- ``flash_attention``: ``csrc/flash_attention_fwd.cu``; CPU tensors take
  :func:`_dense_attention_reference`;
- ``flash_attention_bwd_dkdv`` and ``flash_attention_bwd_dq``:
  ``csrc/flash_attention_bwd.cu``; CPU tensors take
  :func:`_flash_bwd_dkdv_reference` and :func:`_flash_bwd_dq_reference`.

When an input requires grad, :func:`flash_attention` goes through
:class:`_FlashAttentionFunction` on either device, so the CPU runs the same
wiring with the plain bodies that the card runs with the kernels.
"""

import ctypes
import math

import torch

from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.ops.kernels import _build, registry

__all__ = ["flash_attention"]

NAME = "flash_attention"
DKDV = "flash_attention_bwd_dkdv"
DQ = "flash_attention_bwd_dq"
_NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64)
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_TAIL = [ctypes.c_float, _I, _I, _P]       # scale, causal, dtype, stream
_FWD_SIGNATURES = {
    "pt_flash_attention_fwd": [_P] * 6 + [_I] * 4 + [_L] * 9 + _TAIL,
}
_BWD_SIGNATURES = {
    "pt_flash_attention_bwd_dkdv": [_P] * 10 + [_I] * 4 + [_L] * 12 + _TAIL,
    "pt_flash_attention_bwd_dq": [_P] * 8 + [_I] * 4 + [_L] * 12 + _TAIL,
}


def flash_attention(q, k, v, bias=None, causal=False, sm_scale=None,
                    return_lse=False):
    """Blockwise (flash) attention forward.

    q, k, v: [B, H, S, D]. bias: optional additive key bias with B*S
    elements ([B, S], e.g. a key-padding mask of 0 / -1e9). ``sm_scale``
    defaults to 1/sqrt(D). Returns o [B, H, S, D] in q's dtype, or
    (o, lse) with lse [B, H, S] fp32 when ``return_lse``.

    CPU tensors take the plain PyTorch bodies; CUDA tensors launch the
    kernels or raise. Differentiable in q, k, v and bias (the backward
    runs the two backward kernels)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, bias)):
        o, lse = _FlashAttentionFunction.apply(q, k, v, bias, causal,
                                               sm_scale)
        return (o, lse) if return_lse else o
    return registry.dispatch(NAME, q, k, v, bias=bias, causal=causal,
                             sm_scale=sm_scale, return_lse=return_lse)


class _FlashAttentionFunction(torch.autograd.Function):
    """Forward: the registered forward body, with o and lse saved.
    Backward: ``_flash_attention_bwd`` (pallas_kernels.py:269-339):
    delta = sum_D dO * O in fp32 with PyTorch ops, then the dK/dV and dQ
    bodies; dbias is the per-head key-bias grad summed over heads."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal, sm_scale):
        o, lse = registry.dispatch(NAME, q, k, v, bias=bias, causal=causal,
                                   sm_scale=sm_scale, return_lse=True)
        ctx.save_for_backward(q, k, v, bias, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, bias, o, lse = ctx.saved_tensors
        delta = (do.float() * o.float()).sum(-1)
        kw = dict(causal=ctx.causal, sm_scale=ctx.sm_scale)
        dk, dv, dbh = registry.dispatch(DKDV, q, k, v, bias, do, lse, delta,
                                        **kw)
        dq = registry.dispatch(DQ, q, k, v, bias, do, lse, delta, **kw)
        dbias = None
        if ctx.needs_input_grad[3]:
            dbias = dbh.sum(1).reshape(bias.shape).to(bias.dtype)
        return dq, dk, dv, dbias, None, None


# ---------------------------------------------------------------------------
# plain PyTorch bodies
# ---------------------------------------------------------------------------
def _masked_scores(q, k, bias, causal, sm_scale):
    """(q * scale, scores) in fp32 with the key bias and the causal mask
    applied as ``_masked_scores`` (pallas_kernels.py:68-83) does: shared by
    the forward and both backward bodies so masking cannot drift."""
    b, h, s, d = q.shape
    qs = q.float() * sm_scale
    scores = torch.einsum("bhqd,bhkd->bhqk", qs, k.float())
    if bias is not None:
        scores = scores + bias.float().reshape(b, s)[:, None, None, :]
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~keep, _NEG_INF)
    return qs, scores


def _scale(q, sm_scale):
    return 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale


def _dense_attention_reference(q, k, v, bias=None, causal=False,
                               sm_scale=None, return_lse=False):
    """Plain PyTorch attention with the [S, S] scores materialized: the
    semantic reference the kernel is held against."""
    _, scores = _masked_scores(q, k, bias, causal, _scale(q, sm_scale))
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
    if return_lse:
        return o, torch.logsumexp(scores, dim=-1)
    return o


def _recompute_dz(q, k, v, bias, do, lse, delta, causal, sm_scale):
    """The backward's shared recompute: p = exp(s - lse) and
    dz = p * (dO V^T - delta), all fp32 [B, H, S, S]."""
    qs, s = _masked_scores(q, k, bias, causal, sm_scale)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    return qs, p, p * (dp - delta[..., None])


def _flash_bwd_dkdv_reference(q, k, v, bias, do, lse, delta, causal=False,
                              sm_scale=None):
    """dK, dV (in k's and v's dtypes) and the per-head key-bias grad
    dbh [B, H, S] fp32: the math of ``_flash_bwd_dkdv_kernel``
    (pallas_kernels.py:182-227) with the scores materialized."""
    qs, p, dz = _recompute_dz(q, k, v, bias, do, lse, delta, causal,
                              _scale(q, sm_scale))
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", dz, qs)
    return dk.to(k.dtype), dv.to(v.dtype), dz.sum(2)


def _flash_bwd_dq_reference(q, k, v, bias, do, lse, delta, causal=False,
                            sm_scale=None):
    """dQ in q's dtype: the math of ``_flash_bwd_dq_kernel``
    (pallas_kernels.py:230-266) with the scores materialized."""
    sm_scale = _scale(q, sm_scale)
    _, _, dz = _recompute_dz(q, k, v, bias, do, lse, delta, causal, sm_scale)
    return (torch.einsum("bhqk,bhkd->bhqd", dz, k.float())
            * sm_scale).to(q.dtype)


# ---------------------------------------------------------------------------
# CUDA bodies
# ---------------------------------------------------------------------------
def _check_heads(name, q, named):
    """q and every tensor in ``named`` ({name: t}) on one CUDA device, of
    one dtype (fp32 or bf16), [B, H, S, D] with a unit-stride last axis
    and D a head size the kernels take. Returns (B, H, S, D)."""
    if q.dim() != 4:
        raise EnforceNotMet(f"{name}: q must be [B, H, S, D], got shape "
                            f"{tuple(q.shape)}")
    b, h, s, d = q.shape
    for nm, t in named.items():
        if t.device.type != "cuda" or t.device != q.device:
            raise EnforceNotMet(f"{name}: {nm} must be on the CUDA device "
                                f"of q ({q.device}), got {t.device}")
        if t.dtype != q.dtype or t.dtype not in _DTYPE_CODES:
            raise EnforceNotMet(f"{name}: q, k, v must all be float32 or "
                                f"all bfloat16, got {nm} {t.dtype} with q "
                                f"{q.dtype}")
        if tuple(t.shape) != (b, h, s, d) or t.stride(-1) != 1:
            raise EnforceNotMet(
                f"{name}: {nm} must be [B, H, S, D] = {(b, h, s, d)} with a "
                f"unit-stride last axis, got {tuple(t.shape)} strides "
                f"{t.stride()}")
    if d not in _HEAD_DIMS:
        raise EnforceNotMet(f"{name}: the kernel takes head_dim in "
                            f"{_HEAD_DIMS}, got {d}")
    if b * h > 65535:
        raise EnforceNotMet(f"{name}: the kernel takes B*H <= 65535, got "
                            f"{b * h}")
    return b, h, s, d


def _bias_arg(name, bias, b, s, device):
    """The key bias as the kernels read it: [B, S] fp32 contiguous."""
    if bias is None:
        return None
    if bias.device != device or bias.numel() != b * s:
        raise EnforceNotMet(
            f"{name}: bias must hold B*S = {b * s} elements on {device}, got "
            f"{tuple(bias.shape)} on {bias.device}")
    return bias.to(torch.float32).reshape(b, s).contiguous()


def _rows_arg(name, nm, t, b, h, s, device):
    """lse / delta as the kernels read them: [B, H, S] fp32 contiguous."""
    if (t.device != device or t.dtype != torch.float32
            or tuple(t.shape) != (b, h, s) or not t.is_contiguous()):
        raise EnforceNotMet(
            f"{name}: {nm} must be a contiguous float32 [B, H, S] = "
            f"{(b, h, s)} tensor on {device}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}")
    return t


def _tma_ready(t):
    """Whether the bf16 kernels' TMA loads take the [B, H, S, D] view ``t``
    as it is: a 16-byte aligned base, and strides over B, H and S (of the
    axes longer than 1) that are nonzero multiples of 16 bytes. The fused
    QKV projection's head views (bert.py: row stride 3 * N * D, heads D
    apart) are."""
    e = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        st > 0 and st * e % 16 == 0
        for n, st in zip(t.shape[:3], t.stride()[:3]) if n > 1)


def _operands(ts):
    """The [B, H, S, D] operands as the kernel takes them: bf16 views the
    TMA loads cannot take become contiguous copies (fresh, so aligned) for
    the same kernel; fp32 runs the SIMT kernels, which take any strides."""
    return [t.clone(memory_format=torch.contiguous_format)
            if t.dtype == torch.bfloat16 and not _tma_ready(t) else t
            for t in ts]


def _strides(t):
    """Strides over (B, H, S) in elements; an axis of length 1 gets the
    view's span (rounded up to 16 bytes) in place of whatever stride it has,
    which the kernels never step along but the tensor map must accept."""
    span = -(-max(n * s for n, s in zip(t.shape, t.stride())) // 8) * 8
    return tuple(s if n > 1 else span
                 for n, s in zip(t.shape[:3], t.stride()[:3]))


def _flash_attention_cuda(q, k, v, bias=None, causal=False, sm_scale=None,
                          return_lse=False):
    """Launch ``csrc/flash_attention_fwd.cu`` on the current stream (no
    sync). q/k/v may be strided views (e.g. heads split out of a fused
    [B, S, 3*N*D] projection) as long as the last axis is unit-stride."""
    b, h, s, d = _check_heads(NAME, q, {"q": q, "k": k, "v": v})
    q, k, v = _operands((q, k, v))
    bias = _bias_arg(NAME, bias, b, s, q.device)
    o = torch.empty((b, h, s, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    lib = _build.load("flash_attention_fwd", _FWD_SIGNATURES)
    _build.launch(lib, "pt_flash_attention_fwd", NAME, q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(),
            o.data_ptr(), lse.data_ptr(), b, h, s, d,
            *_strides(q), *_strides(k), *_strides(v),
            float(_scale(q, sm_scale)), int(bool(causal)),
            _DTYPE_CODES[q.dtype])
    if return_lse:
        return o, lse
    return o


def _bwd_args(name, q, k, v, bias, do, lse, delta):
    """(B, H, S, D), the operands as the kernel reads them, and their
    strides. The caller holds the operands until the launch: a copy made
    here (a bias cast, a view the TMA loads cannot take) must outlive it,
    or its memory goes back to the allocator under the kernel's reads."""
    b, h, s, d = _check_heads(name, q, {"q": q, "k": k, "v": v, "do": do})
    q, k, v, do = _operands((q, k, v, do))
    bias = _bias_arg(name, bias, b, s, q.device)
    lse = _rows_arg(name, "lse", lse, b, h, s, q.device)
    delta = _rows_arg(name, "delta", delta, b, h, s, q.device)
    strides = (*_strides(q), *_strides(k), *_strides(v), *_strides(do))
    return (b, h, s, d), (q, k, v, bias, do, lse, delta), strides


def _ptrs(ts):
    return [None if t is None else t.data_ptr() for t in ts]


def _flash_bwd_dkdv_cuda(q, k, v, bias, do, lse, delta, causal=False,
                         sm_scale=None):
    """Launch the dK/dV kernel of ``csrc/flash_attention_bwd.cu`` on the
    current stream (no sync). Returns dk, dv (contiguous, in k's dtype)
    and dbh [B, H, S] fp32. q/k/v/do may be strided views."""
    (b, h, s, d), operands, strides = _bwd_args(DKDV, q, k, v, bias, do,
                                                lse, delta)
    dk = torch.empty((b, h, s, d), dtype=k.dtype, device=q.device)
    dv = torch.empty_like(dk)
    dbh = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    lib = _build.load("flash_attention_bwd", _BWD_SIGNATURES)
    _build.launch(lib, "pt_flash_attention_bwd_dkdv", DKDV, q.device,
            *_ptrs(operands), dk.data_ptr(), dv.data_ptr(), dbh.data_ptr(),
            b, h, s, d, *strides, float(_scale(q, sm_scale)),
            int(bool(causal)), _DTYPE_CODES[q.dtype])
    return dk, dv, dbh


def _flash_bwd_dq_cuda(q, k, v, bias, do, lse, delta, causal=False,
                       sm_scale=None):
    """Launch the dQ kernel of ``csrc/flash_attention_bwd.cu`` on the
    current stream (no sync). Returns dq, contiguous, in q's dtype."""
    (b, h, s, d), operands, strides = _bwd_args(DQ, q, k, v, bias, do, lse,
                                                delta)
    dq = torch.empty((b, h, s, d), dtype=q.dtype, device=q.device)
    lib = _build.load("flash_attention_bwd", _BWD_SIGNATURES)
    _build.launch(lib, "pt_flash_attention_bwd_dq", DQ, q.device,
            *_ptrs(operands), dq.data_ptr(), b, h, s, d, *strides,
            float(_scale(q, sm_scale)), int(bool(causal)),
            _DTYPE_CODES[q.dtype])
    return dq
