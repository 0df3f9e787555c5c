"""The port's kernels (paddle_tpu_torch.ops.kernels) against the JAX package.

On the CPU each wrapper runs its plain PyTorch body; that body is held
against the JAX Pallas kernel run in interpret mode on the same numpy
inputs. The CUDA kernels are held against the plain bodies on the card by
``tests/test_torch_cuda.py``.

Tolerances: fp32 results differ only by summation order (fp32 rounding,
~1e-6 relative), so fp32 is held to 1e-5 (LayerNorm) or 2e-5 (attention,
online vs two-pass softmax). bf16 outputs are computed in fp32 by both and
rounded once to bf16, so they may differ by one bf16 unit in the last place:
rtol 2^-7 plus a small atol.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import pallas_kernels as pk
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
        return x.float().numpy()
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
# registry: selection follows the device, counters count kernel launches
# ---------------------------------------------------------------------------
def test_cpu_dispatch_takes_reference_and_counts_nothing():
    K.reset_launch_counts()
    x = torch.randn(8, 32)
    K.fused_layer_norm(x, torch.ones(32), torch.zeros(32))
    q = torch.randn(1, 2, 8, 16)
    K.flash_attention(q, q, q, causal=True)
    assert K.launch_counts() == {"flash_attention": 0, "fused_layer_norm": 0}
    for name in ("flash_attention", "fused_layer_norm"):
        assert K.selected_body(name, "cpu") == "reference"
        assert K.selected_body(name, torch.device("cuda", 0)) == "kernel"
        with pytest.raises(EnforceNotMet):
            K.selected_body(name, "meta")


def test_registry_lists_ported_kernels_with_provenance():
    assert K.list_kernels() == ["flash_attention", "fused_layer_norm"]
    for name in K.list_kernels():
        kd = K.get_kernel(name)
        assert kd.source.startswith("paddle_tpu_torch/ops/kernels/csrc/")
        assert kd.replaces.startswith("paddle_tpu/ops/pallas_kernels.py:")
        assert K.get_body(name, "reference") is kd.reference
        assert K.get_body(name, "kernel") is kd.kernel
        with pytest.raises(EnforceNotMet):
            K.get_body(name, "pallas")


@pytest.mark.parametrize("name", ["fused_layer_norm", "flash_attention"])
def test_kernel_body_refuses_cpu_tensors(name):
    # no fallback: the kernel body never computes on the CPU
    x = torch.randn(1, 2, 8, 16)
    args = (x, torch.ones(16), torch.zeros(16)) if name == \
        "fused_layer_norm" else (x, x, x)
    with pytest.raises(EnforceNotMet):
        K.get_body(name, "kernel")(*args)
    assert K.get_kernel(name).launches == 0


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
        assert "Replaces: paddle_tpu/ops/pallas_kernels.py:" in head
        assert "What bounds it on the H100" in head
