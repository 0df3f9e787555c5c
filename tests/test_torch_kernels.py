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
_NAMES = ["embedding_gather", "flash_attention", "flash_attention_bwd_dkdv",
          "flash_attention_bwd_dq", "fused_adam", "fused_layer_norm",
          "fused_matmul", "fused_momentum", "fused_sgd"]


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
    K.fused_sgd([p], [torch.ones(5)], 0.1)
    K.fused_momentum([p], [torch.ones(5)], [torch.zeros(5)], 0.1)
    assert t.grad is not None and w.grad is not None
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
        "fused_sgd": ([x], [x], 0.1),
        "fused_momentum": ([x], [x], [x], 0.1),
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
