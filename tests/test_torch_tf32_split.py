"""The accuracy argument of the fused matmul kernel, pinned on the CPU.

``csrc/fused_matmul.cu`` runs fp32 products on the tensor cores in TF32 (10
explicit mantissa bits). Each fp32 operand v is split into hi = tf32(v) and
lo = tf32(v - hi), rounded to nearest (``cvt.rna.tf32.f32``), and each
k-step sums a_hi b_hi + a_hi b_lo + a_lo b_hi in fp32. ``chip_smoke.py``
holds the kernel to atol 1e-4, rtol 1e-4 against the fp32 product. This file
emulates the TF32 rounding in plain PyTorch and shows, at word2vec's and
BERT's shapes, that the three passes meet that tolerance and that one pass
(plain TF32) does not; and that the kernel's guard for inf and NaN (a copy
of hi with them zeroed for the cross passes) gives what the fp32 product
gives where the naive split gives NaN. The emulation is a test helper, not
a body of the port: each pass is an fp32 matmul of TF32 values, whose
products are exact in fp32 as the tensor cores' are.
"""

import math

import numpy as np
import pytest
import torch

ATOL = RTOL = 1e-4      # chip_smoke.py's fused-matmul tolerance


def tf32(x):
    """fp32 x rounded to TF32, to nearest with ties away from zero: add half
    a unit of the 13 dropped bits to the magnitude, then clear them."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & -0x2000).view(torch.float32)


def split(x, guard=True):
    """(hi, hif, lo) as the kernel stores them; ``guard=False`` is the naive
    split, where hif is hi and lo of inf is inf - inf."""
    hi = tf32(x)
    if not guard:
        return hi, hi, tf32(x - hi)
    finite = x.isfinite()
    return (hi, torch.where(finite, hi, 0.0),
            torch.where(finite, tf32(x - hi), 0.0))


def tf32_product(x, w, passes, guard=True):
    """x @ w with TF32 operands: one pass (hi hi), two (w has no lo part),
    or three (hi hi + hif lo + lo hif)."""
    xh, xf, xl = split(x, guard)
    wh, wf, wl = split(w, guard)
    out = xh @ wh
    if passes >= 2:
        out = out + xl @ wf
    if passes == 3:
        out = out + xf @ wl
    return out


def worst(a, b):
    """The largest |a - b| in units of the tolerance at b: <= 1 is within."""
    return ((a - b).abs() / (ATOL + RTOL * b.abs())).max().item()


def within(a, b):
    return worst(a, b) <= 1.0


def _operands(m, k, n, seed):
    """x ~ N(0, 1) and w ~ N(0, 1/k), as chip_smoke.py draws them: outputs
    of order 1."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((k, n)) / math.sqrt(k))
                         .astype(np.float32))
    return x, w


_SHAPES = {"word2vec": (100, 256, 2073), "bert_ffn": (512, 768, 3072)}


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11,
                      -(1.0 + 2 ** -11), 1.0 + 2 ** -12, 3.0e-40, math.inf,
                      -math.inf])
    got = tf32(x)
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -9,
                         -(1.0 + 2 ** -10), 1.0, got[5].item(), math.inf,
                         -math.inf])
    assert torch.equal(got, want)
    assert (got.view(torch.int32) & 0x1FFF == 0).all()
    # a split carries 21 significant bits: hi + lo within 2^-21 of x
    x = torch.randn(10000, generator=torch.Generator().manual_seed(0))
    hi, _, lo = split(x)
    assert ((hi + lo - x).abs() <= 2.0 ** -21 * x.abs()).all()


@pytest.mark.parametrize("shape", sorted(_SHAPES))
def test_three_tf32_passes_meet_the_fp32_tolerance(shape):
    m, k, n = _SHAPES[shape]
    x, w = _operands(m, k, n, seed=k)
    ref = x @ w
    # with room: the three passes sit within a tenth of the tolerance, as
    # near the exact product as the fp32 product itself (~0.01-0.04)
    assert worst(tf32_product(x, w, 3), ref) < 0.1


@pytest.mark.parametrize("shape", sorted(_SHAPES))
def test_one_tf32_pass_misses_the_fp32_tolerance(shape):
    m, k, n = _SHAPES[shape]
    x, w = _operands(m, k, n, seed=k)
    ref = x @ w
    # by far: ~12x the tolerance at its worst output at both shapes
    assert worst(tf32_product(x, w, 1), ref) > 5.0


def test_a_bf16_weight_needs_two_passes():
    # a bf16 value is exact in TF32 (lo = 0): hi hi + lo hif suffices
    m, k, n = _SHAPES["word2vec"]
    x, w = _operands(m, k, n, seed=3)
    w = w.bfloat16().float()
    assert torch.equal(tf32(w), w)
    assert within(tf32_product(x, w, 2), x @ w)


@pytest.mark.parametrize("w_val", [1.0, 0.99999, 1.0001])
def test_inf_times_weight_keeps_the_fp32_product(w_val):
    # x holds inf: the fp32 product is inf in every column where w is not
    # 0. A naive split multiplies inf by w's lo: NaN where lo is 0 (w = 1.0,
    # exact in TF32), -inf where lo < 0 (0.99999, cancelling pass one's
    # +inf into NaN); the kernel's hif (inf zeroed) keeps the cross passes
    # finite
    x = torch.tensor([[math.inf, 2.0], [1.5, -math.nan]])
    w = torch.tensor([[w_val, 0.5], [0.25, 0.75]])
    ref = x @ w
    got = tf32_product(x, w, 3)
    assert torch.equal(got.isnan(), ref.isnan())
    assert torch.equal(got[0], ref[0])
    if w_val != 1.0001:      # lo > 0 leaves the naive split right by luck
        assert tf32_product(x, w, 3, guard=False)[0, 0].isnan()
