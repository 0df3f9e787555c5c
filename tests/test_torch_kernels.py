"""The port's kernels (paddle_tpu_torch.ops.kernels) against the JAX package.

On the CPU each wrapper runs its plain PyTorch body; that body is held
against the JAX Pallas kernel run in interpret mode on the same numpy
inputs. The CUDA kernels are held against the plain bodies on the card by
``tests/test_torch_cuda.py``.

Gradients: the port's backward bodies (flash dK/dV and dQ) are fed the
residuals the Pallas backward kernels get and held against them; the
autograd Functions (flash attention, LayerNorm) are held against
``jax.vjp`` of the JAX functions, which run the Pallas kernels and
``_fused_ln_bwd``; the plain fused-Adam body against ``fused_adam_pallas``.

Tolerances: fp32 results differ only by summation order (fp32 rounding,
~1e-6 relative), so fp32 is held to 1e-5 (LayerNorm) or 2e-5 (attention,
online vs two-pass softmax). bf16 outputs are computed in fp32 by both and
rounded once to bf16, so they may differ by one bf16 unit in the last place:
rtol 2^-7 plus a small atol. Each gradient test states its own.
"""

import os
import re
import types
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu.ops.pallas import optimizer as popt
from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.ops.kernels import _build

BF16_RTOL = 2.0 ** -7    # one bf16 unit in the last place, relative

_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a, dtype):
    """The same numpy values as a JAX array and a CPU torch tensor."""
    jd, td = _DTYPES[dtype]
    return jnp.asarray(a, jd), torch.tensor(a).to(td)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tols(dtype, fp32_tol):
    return ((1e-5, BF16_RTOL) if dtype == "bfloat16"
            else (fp32_tol, fp32_tol))


# ---------------------------------------------------------------------------
# LayerNorm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [256, 300])   # 300: ragged vs block_n 128
def test_layer_norm_reference_matches_pallas(dtype, rows):
    rng = np.random.RandomState(rows)
    x = (rng.randn(rows, 96) * 3 + 1).astype(np.float32)
    g = rng.randn(96).astype(np.float32)
    b = rng.randn(96).astype(np.float32)
    xj, xt = _pair(x, dtype)
    yj = pk.fused_layer_norm(xj, jnp.asarray(g), jnp.asarray(b), eps=1e-12,
                             block_n=128, interpret=True)
    yt = K.fused_layer_norm(xt, torch.tensor(g), torch.tensor(b), eps=1e-12)
    assert yt.dtype == xt.dtype and yt.shape == xt.shape
    atol, rtol = _tols(dtype, 1e-5)
    np.testing.assert_allclose(_np(yt), _np(yj), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_stats_match_pallas(dtype):
    rng = np.random.RandomState(1)
    x = (rng.randn(2, 128, 64) * 2 - 0.5).astype(np.float32)
    g = rng.randn(64).astype(np.float32)
    b = rng.randn(64).astype(np.float32)
    xj, xt = _pair(x, dtype)
    yj, muj, rstdj = pk._ln_fwd(xj.reshape(256, 64), jnp.asarray(g),
                                jnp.asarray(b), 1e-12, 128, True)
    yt, mut, rstdt = K.fused_layer_norm(xt, torch.tensor(g), torch.tensor(b),
                                        return_stats=True)
    assert mut.shape == rstdt.shape == (2, 128)
    assert mut.dtype == rstdt.dtype == torch.float32
    atol, rtol = _tols(dtype, 1e-5)
    np.testing.assert_allclose(_np(yt).reshape(256, 64), _np(yj),
                               atol=atol, rtol=rtol)
    np.testing.assert_allclose(_np(mut).ravel(), _np(muj), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(_np(rstdt).ravel(), _np(rstdj), rtol=1e-5)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------
_FLASH_CASES = [
    # (B, H, S, D, dtype, causal, bias)
    (2, 2, 256, 32, "float32", False, False),
    (2, 2, 256, 32, "float32", True, True),
    (1, 2, 200, 16, "float32", False, True),     # unaligned S, 128 blocks
    (1, 2, 200, 16, "float32", True, False),
    (2, 2, 256, 64, "bfloat16", False, True),
    (1, 2, 200, 64, "bfloat16", True, True),
]


def _flash_inputs(B, H, S, D, with_bias, seed):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, H, S, D).astype(np.float32) for _ in range(3))
    bias = None
    if with_bias:
        bias = np.where(rng.rand(B, S) < 0.2, -1e9, 0.0).astype(np.float32)
        bias[:, 0] = 0.0
    return q, k, v, bias


def _jax_flash_with_lse(qj, kj, vj, bias, causal):
    """The Pallas forward in interpret mode with lse, padded to the 128
    grain with a -1e30 key bias as its wrapper pads."""
    b, h, s, d = qj.shape
    pad = (-s) % 128
    bj = jnp.zeros((b, s), jnp.float32) if bias is None else jnp.asarray(bias)
    zf = ((0, 0), (0, 0), (0, pad), (0, 0))
    o, lse = pk._flash_fwd(
        jnp.pad(qj, zf), jnp.pad(kj, zf), jnp.pad(vj, zf),
        jnp.pad(bj, ((0, 0), (0, pad)), constant_values=-1e30),
        1.0 / np.sqrt(d), causal, 128, 128, True)
    return o[:, :, :s], lse[:, :, :s]


@pytest.mark.parametrize("B,H,S,D,dtype,causal,with_bias", _FLASH_CASES)
def test_flash_reference_matches_pallas(B, H, S, D, dtype, causal,
                                        with_bias):
    q, k, v, bias = _flash_inputs(B, H, S, D, with_bias, seed=S + D)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in (q, k, v))
    oj = pk.flash_attention(qj, kj, vj, bias=bias, causal=causal,
                            block_q=128, block_k=128, interpret=True)
    ot, lset = K.flash_attention(
        qt, kt, vt, bias=None if bias is None else torch.tensor(bias),
        causal=causal, return_lse=True)
    assert ot.dtype == qt.dtype and ot.shape == qt.shape
    assert lset.shape == (B, H, S) and lset.dtype == torch.float32
    atol, rtol = _tols(dtype, 2e-5)
    if dtype == "bfloat16":
        atol = 1e-4
    np.testing.assert_allclose(_np(ot), _np(oj), atol=atol, rtol=rtol)
    oj2, lsej = _jax_flash_with_lse(qj, kj, vj, bias, causal)
    np.testing.assert_allclose(_np(oj2), _np(oj), atol=0, rtol=0)
    np.testing.assert_allclose(_np(lset), _np(lsej), atol=1e-4, rtol=1e-6)


def test_flash_reference_takes_strided_head_views():
    # the model hands the kernel heads split out of a fused [B,S,3*N*D]
    # projection; the plain body must give the same as contiguous inputs
    rng = np.random.RandomState(3)
    B, S, N, D = 2, 40, 2, 16
    qkv = torch.tensor(rng.randn(B, S, 3 * N * D).astype(np.float32))
    q, k, v = (t.reshape(B, S, N, D).transpose(1, 2)
               for t in qkv.split(N * D, dim=-1))
    assert not q.is_contiguous()
    o = K.flash_attention(q, k, v)
    oc = K.flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    torch.testing.assert_close(o, oc, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------
_FLASH_BWD_CASES = [
    # (B, H, S, D, dtype, causal, bias)
    (1, 2, 200, 16, "float32", True, True),      # unaligned S, masked keys
    (2, 2, 128, 32, "float32", False, True),
    (1, 2, 130, 64, "float32", False, False),    # two keys past the grain
    (1, 2, 256, 64, "float32", True, False),
    (2, 2, 128, 64, "bfloat16", False, True),
    (1, 2, 200, 32, "bfloat16", True, True),
]


def _jax_flash_bwd(qj, kj, vj, bias, doj, causal):
    """The Pallas backward kernels in interpret mode, fed as
    ``_flash_attention_bwd`` feeds them from the forward's residuals, on
    inputs padded as the wrapper pads them (zero dO rows, -1e30 key bias).
    Returns (dq, dk, dv, dbias, lse, delta) cut back to S."""
    b, h, s, d = qj.shape
    pad = (-s) % 128
    bj = jnp.zeros((b, s), jnp.float32) if bias is None else jnp.asarray(bias)
    zf = ((0, 0), (0, 0), (0, pad), (0, 0))
    qp, kp, vp, dop = (jnp.pad(t, zf) for t in (qj, kj, vj, doj))
    bp = jnp.pad(bj, ((0, 0), (0, pad)), constant_values=-1e30)
    scale = 1.0 / np.sqrt(d)
    o, lse = pk._flash_fwd(qp, kp, vp, bp, scale, causal, 128, 128, True)
    dq, dk, dv, dbias = pk._flash_attention_bwd(
        scale, causal, 128, 128, True, (qp, kp, vp, bp, o, lse), dop)
    delta = jnp.sum(dop.astype(jnp.float32) * o.astype(jnp.float32), -1)
    cut = (slice(None), slice(None), slice(0, s))
    return (dq[cut], dk[cut], dv[cut], dbias[:, :s], lse[cut], delta[cut])


@pytest.mark.parametrize("B,H,S,D,dtype,causal,with_bias", _FLASH_BWD_CASES)
def test_flash_backward_references_match_pallas(B, H, S, D, dtype, causal,
                                                with_bias):
    q, k, v, bias = _flash_inputs(B, H, S, D, with_bias, seed=S + D + 1)
    do = np.random.RandomState(S).randn(B, H, S, D).astype(np.float32)
    (qj, qt), (kj, kt), (vj, vt), (doj, dot) = (
        _pair(a, dtype) for a in (q, k, v, do))
    dqj, dkj, dvj, dbj, lse, delta = _jax_flash_bwd(qj, kj, vj, bias, doj,
                                                    causal)
    args = (qt, kt, vt, None if bias is None else torch.tensor(bias), dot,
            torch.tensor(np.asarray(lse)), torch.tensor(np.asarray(delta)))
    dk, dv, dbh = K.dispatch("flash_attention_bwd_dkdv", *args,
                             causal=causal)
    dq = K.dispatch("flash_attention_bwd_dq", *args, causal=causal)
    for t, ref in ((dq, qt), (dk, kt), (dv, vt)):
        assert t.dtype == ref.dtype and t.shape == ref.shape
    assert dbh.shape == (B, H, S) and dbh.dtype == torch.float32
    # the same residuals in: the bodies differ from the Pallas kernels by
    # summation order only (fp32: 1e-5; bf16: one unit in the last place
    # of the rounded result, atol 1e-4 near zero); dbh is fp32 in both
    atol, rtol = (1e-4, BF16_RTOL) if dtype == "bfloat16" else (1e-5, 1e-5)
    for got, want in ((dq, dqj), (dk, dkj), (dv, dvj)):
        np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol)
    np.testing.assert_allclose(_np(dbh.sum(1)), _np(dbj), atol=1e-4,
                               rtol=1e-5)


@pytest.mark.parametrize("B,H,S,D,dtype,causal,with_bias", _FLASH_BWD_CASES)
def test_flash_function_matches_jax_vjp(B, H, S, D, dtype, causal,
                                        with_bias):
    q, k, v, bias = _flash_inputs(B, H, S, D, with_bias, seed=S + D + 2)
    if bias is None:
        bias = np.zeros((B, S), np.float32)
    do = np.random.RandomState(S + 1).randn(B, H, S, D).astype(np.float32)
    (qj, qt), (kj, kt), (vj, vt), (doj, dot) = (
        _pair(a, dtype) for a in (q, k, v, do))
    oj, vjp = jax.vjp(
        lambda q_, k_, v_, b_: pk.flash_attention(
            q_, k_, v_, bias=b_, causal=causal, block_q=128, block_k=128,
            interpret=True), qj, kj, vj, jnp.asarray(bias))
    grads_j = vjp(doj)
    leaves = [t.clone().requires_grad_() for t in (qt, kt, vt)]
    bt = torch.tensor(bias).requires_grad_()
    ot = K.flash_attention(*leaves, bias=bt, causal=causal)
    ot.backward(dot)
    # fp32: summation order (observed <= 2e-6): 2e-5. bf16: o may round one
    # unit apart, which moves delta = sum dO*O and through it every grad by
    # about a unit of its own (observed dq 7.8e-3 at |dq| <= 1.4): two
    # units (rtol 2^-6) plus atol 1e-2; dbias is fp32: atol 2e-3
    atol, rtol = ((1e-2, 2 * BF16_RTOL) if dtype == "bfloat16"
                  else (2e-5, 2e-5))
    np.testing.assert_allclose(_np(ot), _np(oj), atol=atol, rtol=rtol)
    for got, want in zip([t.grad for t in leaves], grads_j[:3]):
        assert got.dtype == leaves[0].dtype
        np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol)
    np.testing.assert_allclose(
        _np(bt.grad), _np(grads_j[3]),
        atol=2e-3 if dtype == "bfloat16" else 2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(256, 96), (3, 100, 64)])
def test_layer_norm_function_matches_jax_vjp(dtype, shape):
    rng = np.random.RandomState(len(shape))
    x = (rng.randn(*shape) * 3 + 1).astype(np.float32)
    dy = rng.randn(*shape).astype(np.float32)
    g = rng.randn(shape[-1]).astype(np.float32)
    b = rng.randn(shape[-1]).astype(np.float32)
    (xj, xt), (dyj, dyt) = _pair(x, dtype), _pair(dy, dtype)
    yj, vjp = jax.vjp(
        lambda x_, g_, b_: pk.fused_layer_norm(x_, g_, b_, block_n=128,
                                               interpret=True),
        xj, jnp.asarray(g), jnp.asarray(b))
    dxj, dgj, dbj = vjp(dyj)
    xt = xt.clone().requires_grad_()
    gt, bt = (torch.tensor(a).requires_grad_() for a in (g, b))
    yt = K.fused_layer_norm(xt, gt, bt)
    yt.backward(dyt)
    assert xt.grad.dtype == xt.dtype and gt.grad.dtype == torch.float32
    # dx: fp32 math rounded once to x's dtype (fp32 1e-5; bf16 one unit);
    # dgamma/dbeta: fp32 sums over up to 300 rows in another order: 1e-4
    atol, rtol = _tols(dtype, 1e-5)
    np.testing.assert_allclose(_np(yt), _np(yj), atol=atol, rtol=rtol)
    np.testing.assert_allclose(_np(xt.grad), _np(dxj), atol=1e-4, rtol=rtol)
    for got, want in ((gt.grad, dgj), (bt.grad, dbj)):
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("shape", [(1,), (127,), (3 * 128 + 5,), (33, 70)])
@pytest.mark.parametrize("t", [1, 7])
def test_fused_adam_reference_matches_pallas(shape, t):
    rng = np.random.RandomState(t + len(shape))
    p, g, m1 = (rng.randn(*shape).astype(np.float32) for _ in range(3))
    m2 = np.abs(rng.randn(*shape)).astype(np.float32)
    want = popt.fused_adam_pallas(
        *(jnp.asarray(a) for a in (p, g, m1, m2)), 1e-2, t, beta1=0.9,
        beta2=0.999, epsilon=1e-8, interpret=True)
    pt_, gt, m1t, m2t = (torch.tensor(a) for a in (p, g, m1, m2))
    out = K.fused_adam([pt_], [gt], [m1t], [m2t], 1e-2,
                       torch.tensor(t, dtype=torch.int32))
    assert out is None
    # the same fp32 ops; the Pallas kernel rounds (1-b2)*g*g in another
    # order and pow may differ by an ulp: rtol 1e-6
    for got, w in zip((pt_, m1t, m2t), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)
    np.testing.assert_array_equal(gt.numpy(), g)      # grads untouched


# ---------------------------------------------------------------------------
# registry: selection follows the device, counters count kernel launches
# ---------------------------------------------------------------------------
_NAMES = ["embedding_gather", "embedding_scatter_add", "flash_attention",
          "flash_attention_bwd_dkdv", "flash_attention_bwd_dq", "fused_adam",
          "fused_layer_norm", "fused_matmul", "fused_matmul_int8",
          "fused_momentum", "fused_sgd", "softmax_cross_entropy"]


def test_cpu_dispatch_takes_reference_and_counts_nothing():
    K.reset_launch_counts()
    x = torch.randn(8, 32, requires_grad=True)
    K.fused_layer_norm(x, torch.ones(32), torch.zeros(32)).sum().backward()
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    K.flash_attention(q, q, q, causal=True).sum().backward()
    p = torch.zeros(5)
    K.fused_adam([p], [torch.ones(5)], [torch.zeros(5)], [torch.zeros(5)],
                 0.1, torch.tensor(1, dtype=torch.int32))
    assert q.grad is not None and x.grad is not None and p.abs().sum() > 0
    t = torch.randn(6, 4, requires_grad=True)
    K.embedding_gather(t, torch.tensor([1, 5])).sum().backward()
    w = torch.randn(4, 3, requires_grad=True)
    K.fused_matmul(t, w, None, "relu").sum().backward()
    K.fused_matmul_int8(t.detach(), torch.ones(4, 3, dtype=torch.int8),
                        torch.ones(3), None, "tanh")
    K.fused_sgd([p], [torch.ones(5)], 0.1)
    K.fused_momentum([p], [torch.ones(5)], [torch.zeros(5)], 0.1)
    u = torch.randn(2, 4, requires_grad=True)
    K.embedding_scatter_add(t, torch.tensor([1, 5]), u).sum().backward()
    K.softmax_cross_entropy(t, torch.tensor([0, 1, 2, 3, 0, 1])
                            ).sum().backward()
    assert t.grad is not None and w.grad is not None and u.grad is not None
    assert K.launch_counts() == {n: 0 for n in _NAMES}
    for name in _NAMES:
        assert K.selected_body(name, "cpu") == "reference"
        assert K.selected_body(name, torch.device("cuda", 0)) == "kernel"
        with pytest.raises(EnforceNotMet):
            K.selected_body(name, "meta")


def test_registry_lists_ported_kernels_with_provenance():
    assert K.list_kernels() == _NAMES
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name in K.list_kernels():
        kd = K.get_kernel(name)
        assert kd.source.startswith("paddle_tpu_torch/ops/kernels/csrc/")
        assert os.path.isfile(os.path.join(repo, kd.source))
        # file:line names the Pallas kernel function it replaces
        path, line = kd.replaces.split(":")
        assert path.startswith("paddle_tpu/ops/pallas")
        with open(os.path.join(repo, path)) as f:
            src = f.read().splitlines()[int(line) - 1]
        assert re.match(r"def _\w+_kernel\(", src), (name, src)
        assert K.get_body(name, "reference") is kd.reference
        assert K.get_body(name, "kernel") is kd.kernel
        with pytest.raises(EnforceNotMet):
            K.get_body(name, "pallas")


@pytest.mark.parametrize("name", _NAMES)
def test_kernel_body_refuses_cpu_tensors(name):
    # no fallback: the kernel body never computes on the CPU
    x = torch.randn(1, 2, 8, 16)
    rows = torch.zeros(1, 2, 8)
    args = {
        "fused_layer_norm": (x, torch.ones(16), torch.zeros(16)),
        "flash_attention": (x, x, x),
        "flash_attention_bwd_dkdv": (x, x, x, None, x, rows, rows),
        "flash_attention_bwd_dq": (x, x, x, None, x, rows, rows),
        "fused_adam": ([x], [x], [x], [x], 0.1,
                       torch.tensor(1, dtype=torch.int32)),
        "embedding_gather": (x[0, 0], torch.tensor([0, 1])),
        "fused_matmul": (x[0, 0], x[0, 0].T, None, "relu"),
        "fused_matmul_int8": (x[0, 0], x[0, 0].T.to(torch.int8),
                              torch.ones(8), None, "relu"),
        "fused_sgd": ([x], [x], 0.1),
        "fused_momentum": ([x], [x], [x], 0.1),
        "embedding_scatter_add": (x[0, 0], torch.tensor([0, 1]),
                                  x[0, 0, :2]),
        "softmax_cross_entropy": (x[0, 0], torch.tensor([0] * 8)),
    }[name]
    before = x.clone()
    with pytest.raises(EnforceNotMet):
        K.get_body(name, "kernel")(*args)
    assert K.get_kernel(name).launches == 0
    assert torch.equal(x, before)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.build(["layer_norm"])


def test_sources_ship_with_the_package():
    for name in _build.SOURCES:
        with open(_build.source_path(name)) as f:
            head = f.read(2000)
        assert "Replaces: paddle_tpu/ops/pallas" in head
        assert "What bounds it on the H100" in head


def test_flash_wrappers_copy_only_views_tma_cannot_take(monkeypatch):
    """The bf16 flash kernels load q, k, v (and dO) by TMA, which needs a
    16-byte aligned base and strides over B, H, S in 16-byte multiples. The
    wrappers pass such views as they are (the fused QKV projection's head
    views among them), copy the others to contiguous tensors for the same
    kernel, never copy fp32 views (the SIMT kernel takes any strides), and
    give axes of length 1 a stride the tensor map accepts. Pinned on the
    CPU with the launch captured in place of the card's."""
    from paddle_tpu_torch.ops.kernels import attention as A
    B, S, N, D = 2, 40, 4, 64
    qkv = torch.randn(B, S, 3 * N * D).bfloat16()
    heads = [t.reshape(B, S, N, D).transpose(1, 2)
             for t in qkv.split(N * D, dim=-1)]
    assert all(A._tma_ready(t) and not t.is_contiguous() for t in heads)
    flat = torch.randn(B * N * S * D + 1).bfloat16()
    shifted = flat[1:].view(B, N, S, D)               # base 2 bytes off
    odd_rows = torch.randn(B, N, S, 100).bfloat16()[..., :D]   # 200 B rows
    assert not A._tma_ready(shifted) and not A._tma_ready(odd_rows)
    assert A._tma_ready(torch.randn(1, N, S, D).bfloat16().contiguous())
    odd32 = torch.randn(B, N, S, 100)[..., :D]
    got = A._operands([heads[0], shifted, odd_rows, odd32])
    assert got[0] is heads[0] and got[3] is odd32
    assert got[1].is_contiguous() and got[2].is_contiguous()
    assert torch.equal(got[1], shifted) and torch.equal(got[2], odd_rows)
    assert A._strides(torch.empty(1, N, 1, D)) == (
        N * D, D, N * D) and A._strides(heads[1]) == heads[1].stride()[:3]

    with pytest.raises(EnforceNotMet, match=r"\[B, H, S, D\]"):
        K.get_body("flash_attention", "kernel")(heads[0][0], heads[1][0],
                                                heads[2][0])

    # the copies live until the launch has read their pointers (a copy
    # freed before it hands its memory to the outputs allocated next)
    launched, copies = [], []
    real_operands = A._operands

    def operands(ts):
        out = real_operands(ts)
        copies.extend(weakref.ref(t) for t, u in zip(out, ts) if t is not u)
        return out

    def launch(lib, fn, name, dev, *args):
        assert all(c() is not None for c in copies), fn
        launched.append((fn, args, len(copies)))
        copies.clear()

    monkeypatch.setattr(A, "_operands", operands)
    monkeypatch.setattr(A, "_check_heads", lambda name, q, named: q.shape)
    monkeypatch.setattr(A._build, "load", lambda *a: None)
    monkeypatch.setattr(A._build, "launch", launch)
    q, k, v = heads[0], shifted, heads[2]
    A._flash_attention_cuda(q, k, v)
    A._flash_bwd_dkdv_cuda(q, k, v, None, odd_rows, torch.zeros(B, N, S),
                           torch.zeros(B, N, S))
    A._flash_bwd_dq_cuda(q, k, v, None, odd_rows, torch.zeros(B, N, S),
                         torch.zeros(B, N, S))
    (_, fwd, n_fwd), (_, dkdv, n_dkdv), (_, dq, n_dq) = launched
    assert (n_fwd, n_dkdv, n_dq) == (1, 2, 2)     # k; k and dO; k and dO
    # forward: q and v as they are, k copied; strides follow the pointers
    assert fwd[0] == q.data_ptr() and fwd[2] == v.data_ptr()
    assert fwd[1] != k.data_ptr()
    assert fwd[10:13] == q.stride()[:3] and fwd[13:16] == (N * S * D, S * D, D)
    # dK/dV and dQ (both TMA kernels): dO (odd rows) copied too, q and v
    # go as they are
    for bwd in (dkdv, dq):
        assert bwd[0] == q.data_ptr() and bwd[2] == v.data_ptr()
        assert bwd[1] != k.data_ptr() and bwd[4] != odd_rows.data_ptr()


@pytest.mark.parametrize("m,k,n,x_dtype,w_dtype", [
    (100, 256, 2073, torch.float32, torch.float32),    # word2vec's fc 2
    (8, 256, 10, torch.float32, torch.float32),        # the serving MLP
    (33, 70, 130, torch.float32, torch.float32),       # the ragged case
    (100, 256, 2073, torch.float32, torch.bfloat16)])  # a bf16 weight
def test_fused_matmul_wrapper_hands_ragged_shapes_to_the_kernel(
        monkeypatch, m, k, n, x_dtype, w_dtype):
    """The fused matmul kernel masks every edge itself (rows of w and x
    aligned to no 16 bytes, N and K multiples of no tile), so the wrapper
    passes x and w as they are, with their own shapes: no padded copy.
    Pinned on the CPU with the launch captured in place of the card's."""
    from paddle_tpu_torch.ops.kernels import matmul as MM
    x = torch.randn(m, k).to(x_dtype)
    w = torch.randn(k, n).to(w_dtype)
    b = torch.randn(n)
    launched = []

    def launch(lib, fn, name, dev, *args):
        launched.append((fn, name, args))

    monkeypatch.setattr(MM._build, "load", lambda *a: None)
    monkeypatch.setattr(MM._build, "launch", launch)
    monkeypatch.setattr(MM._build, "require_cuda", lambda name, what, t: None)
    out = MM._fused_matmul_cuda(x, w, b, "relu")
    ((fn, name, args),) = launched
    assert (fn, name) == ("pt_fused_matmul", "fused_matmul")
    assert args[0] == x.data_ptr() and args[2] == w.data_ptr()
    assert args[1:4:2] == (int(x_dtype == torch.bfloat16),
                           int(w_dtype == torch.bfloat16))
    assert args[4] == b.data_ptr() and args[5] == out.data_ptr()
    assert args[6:9] == (m, n, k) and args[9] == 1    # M, N, K; relu
    assert out.shape == (m, n) and out.dtype == torch.float32
    assert K.launch_counts()["fused_matmul"] == 0


@pytest.mark.parametrize("n", [1, 255, 256, 257, 4096, 8192, 8193])
def test_scatter_add_wrapper_sizes_partials_from_n_and_chunk(monkeypatch, n):
    """The scatter-add kernel keeps two fp32 partial rows of d per chunk of
    ``_CHUNK`` sorted positions: the wrapper allocates ceil(n / _CHUNK) x 2
    x d of them (no table over the h rows), the sort's scratch of the size
    the library gives, int32 sorted keys and order, and hands its own
    pointers and shapes to the kernels. Pinned on the CPU with the launches
    captured in place of the card's."""
    from paddle_tpu_torch.ops.kernels import embedding as E
    h, d = 70, 24
    dst = torch.randn(h, d)
    ids = torch.randint(0, h, (n,))
    upd = torch.randn(n, d)
    launched, scratch = [], []
    real_partials = E._partials

    def partials(n_, d_, dev):
        t = real_partials(n_, d_, dev)
        scratch.append(t)
        return t

    def launch(lib, fn, name, dev, *args, count=True):
        assert name == "embedding_scatter_add"
        launched.append((fn, args, count))

    monkeypatch.setattr(E, "_partials", partials)
    lib = types.SimpleNamespace(
        pt_embedding_scatter_sort_bytes=lambda n_, h_: 8 * n_ + 512)
    monkeypatch.setattr(E._build, "load", lambda *a: lib)
    monkeypatch.setattr(E._build, "launch", launch)
    monkeypatch.setattr(E._build, "require_cuda", lambda name, what, t: None)
    out = E._embedding_scatter_add_cuda(dst, ids, upd)
    (kf, kargs, kcount), (sf, sargs, scount) = launched
    assert (kf, kcount, sf, scount) == ("pt_embedding_scatter_sort", False,
                                        "pt_embedding_scatter_add", True)
    assert kargs[0] == ids.data_ptr() and kargs[1] == 1
    # the scratch's bytes as the library gives them, then n and h
    assert kargs[5:] == (8 * n + 512, n, h)
    # the sorted keys and the order the summing kernel reads
    assert sargs[2:4] == kargs[2:4]
    (part,) = scratch
    assert part.shape == (-(-n // E._CHUNK), 2, d)
    assert part.dtype == torch.float32
    assert sargs[0] == dst.data_ptr() and sargs[1] == upd.data_ptr()
    assert sargs[4] == part.data_ptr() and sargs[5] == out.data_ptr()
    # n, h, d; fp32 dst and updates (the kernel picks its access widths)
    assert sargs[6:] == (n, h, d, 0, 0)
    assert out.shape == dst.shape and out.data_ptr() != dst.data_ptr()
    assert K.launch_counts()["embedding_scatter_add"] == 0


@pytest.mark.parametrize("m,k,n,x_dtype", [
    (8, 256, 10, torch.float32),        # the serving MLP's last fc
    (64, 256, 2073, torch.float32),     # word2vec's fc 2: 2,073-byte rows
    (64, 256, 2073, torch.bfloat16),
    (33, 70, 130, torch.float32)])      # the ragged case
def test_fused_matmul_int8_wrapper_hands_ragged_shapes_to_the_kernel(
        monkeypatch, m, k, n, x_dtype):
    """The int8 entry runs the tensor-core kernel, which reads the int8
    weight as bytes and masks every edge, so the wrapper passes x, w and
    the scale as they are (no padded or dequantized copy of w). Pinned on
    the CPU with the launch captured in place of the card's."""
    from paddle_tpu_torch.ops.kernels import matmul as MM
    x = torch.randn(m, k).to(x_dtype)
    w = torch.randint(-127, 128, (k, n), dtype=torch.int8)
    scale = torch.rand(n) + 0.5
    b = torch.randn(n)
    launched = []

    def launch(lib, fn, name, dev, *args):
        launched.append((fn, name, args))

    monkeypatch.setattr(MM._build, "load", lambda *a: None)
    monkeypatch.setattr(MM._build, "launch", launch)
    monkeypatch.setattr(MM._build, "require_cuda", lambda name, what, t: None)
    out = MM._fused_matmul_int8_cuda(x, w, scale, b, "tanh")
    ((fn, name, args),) = launched
    assert (fn, name) == ("pt_fused_matmul_int8", "fused_matmul_int8")
    assert args[0] == x.data_ptr()
    assert args[1] == int(x_dtype == torch.bfloat16)
    assert args[2] == w.data_ptr() and args[3] == scale.data_ptr()
    assert args[4] == b.data_ptr() and args[5] == out.data_ptr()
    assert args[6:10] == (m, n, k, 3)     # M, N, K; tanh
    assert out.shape == (m, n) and out.dtype == torch.float32
    assert K.launch_counts()["fused_matmul_int8"] == 0
