"""The precision design of the wgmma_f32 route (sps_torch/csrc/
zband_conv_tf32x3_sm90.cu), emulated in numpy on the CPU.

TF32 keeps 10 of f32's 23 mantissa bits. The kernel splits each operand
as x_hi = tf32(x), x_lo = tf32(x - x_hi), rounding to nearest with ties
away from zero (cvt.rna.tf32.f32), and sums A_lo * B_hi, A_hi * B_lo and
A_hi * B_hi per k8 step into f32 accumulators, small terms first. The
emulation takes each k8 step's eight products exactly (f64) and rounds
once into the f32 accumulator, in the kernel's order: 8-channel chunks,
then taps, then the three products.

On K3's f32 operands (hz (B, 10, 10, 160) uniform in [0, 1), the
band-packed He-scaled weight (3, 3, 160, 128), as chip_smoke.py's
make_case draws them) at B = 16 bricks, the 3xTF32 sum holds the bar f32
is held to on the card (rtol 1e-4 / atol 1e-4 against the plain version)
against an f64 sum, and a single TF32 product per multiply-add does not.
"""

import numpy as np
import pytest
import torch

from sps_torch.ops import brick as bk
from sps_torch.ops import zband_conv as zc

RTOL = ATOL = 1e-4


def tf32_rna(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32: round an f32 to 10 mantissa bits, to nearest,
    ties away from zero (finite values)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x: np.ndarray):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def k3_operands(b, seed=0):
    """K3's f32 operands at b bricks: TC 16 in and out, bs 8, k 3."""
    rng = np.random.default_rng(seed)
    hz = rng.random((b, 10, 10, 160), dtype=np.float32)
    w = (rng.standard_normal((3, 3, 3, 16, 16)) * (2.0 / (27 * 16)) ** 0.5).astype(np.float32)
    wz = bk.pack_zband_kernel(torch.from_numpy(w), 8, 1).numpy()
    return hz, wz


def emulate(hz, wz, products):
    """The kernel's sum: for each 8-channel chunk, tap and product (a, b)
    in `products` (pairs of 'hi' / 'lo'), one k8 step's exact sum rounded
    into the f32 accumulator. Returns (B, 8, 8, N) f32."""
    b, h, _, c = hz.shape
    k, n = wz.shape[0], wz.shape[-1]
    parts_a, parts_b = dict(zip(("hi", "lo"), split(hz))), dict(zip(("hi", "lo"), split(wz)))
    acc = np.zeros((b, 8, 8, n), np.float32)
    for q in range(c // 8):
        cs = slice(8 * q, 8 * q + 8)
        for kx in range(k):
            for ky in range(k):
                for pa, pb in products:
                    a = parts_a[pa][:, kx : kx + 8, ky : ky + 8, cs].astype(np.float64)
                    w = parts_b[pb][kx, ky, cs].astype(np.float64)
                    acc = (acc + (a @ w)).astype(np.float32)
    return acc


def reference(hz, wz):
    """The function in f64 (the plain version's sums, exactly)."""
    out = 0.0
    for kx in range(wz.shape[0]):
        for ky in range(wz.shape[1]):
            out = out + hz[:, kx : kx + 8, ky : ky + 8].astype(np.float64) @ wz[kx, ky].astype(
                np.float64)
    return out


def test_tf32_rounding():
    x = np.array([1.0, 1.0 + 2.0**-11, 1.0 + 2.0**-12, -(1.0 + 2.0**-11), 1.0 + 3 * 2.0**-11,
                  3.0e-5, -7.25, 0.0], np.float32)
    got = tf32_rna(x)
    # Ties go away from zero; below a tie rounds down; the low 13 bits are 0.
    np.testing.assert_array_equal(
        got, np.array([1.0, 1.0 + 2.0**-10, 1.0, -(1.0 + 2.0**-10), 1.0 + 2 * 2.0**-10,
                       tf32_rna(np.float32(3.0e-5)), -7.25, 0.0], np.float32))
    assert not (got.view(np.uint32) & np.uint32(0x1FFF)).any()


def test_split_is_exact_to_22_bits():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(100000) * 10.0 ** rng.integers(-3, 3, 100000)).astype(np.float32)
    hi, lo = split(x)
    for part in (hi, lo):
        assert not (part.view(np.uint32) & np.uint32(0x1FFF)).any()
    # x - hi is exact in f32: one rounding to 11 significant bits leaves 13.
    assert (np.abs(x.astype(np.float64) - hi) <= 2.0**-11 * np.abs(x)).all()
    assert (np.abs(x.astype(np.float64) - hi - lo) <= 2.0**-21 * np.abs(x)).all()


@pytest.fixture(scope="module")
def k3():
    hz, wz = k3_operands(16)
    return hz, wz, reference(hz, wz)


def test_3xtf32_holds_the_f32_bar(k3):
    hz, wz, want = k3
    got = emulate(hz, wz, (("lo", "hi"), ("hi", "lo"), ("hi", "hi")))
    err = np.abs(got - want)
    assert (err <= ATOL + RTOL * np.abs(want)).all(), float(err.max())
    # The dropped lo * lo term and the roundings leave f32-sized errors
    # (1.9e-6 of an output max-abs of 3.3 here; the f32 sum of the plain
    # version: 6.8e-7).
    assert float(err.max()) <= 1e-5 * float(np.abs(want).max())


def test_single_tf32_misses_the_f32_bar(k3):
    hz, wz, want = k3
    got = emulate(hz, wz, (("hi", "hi"),))
    err = np.abs(got - want)
    assert not (err <= ATOL + RTOL * np.abs(want)).all()
    assert float(err.max()) > 4 * ATOL


def test_emulation_order_matches_the_kernel():
    """The kernel runs the three products small terms first."""
    src = (zc.CSRC / "zband_conv_tf32x3_sm90.cu").read_text()
    order = ["wgmma_m64n128k8_tf32(acc[bb], a_lo, b_hi);",
             "wgmma_m64n128k8_tf32(acc[bb], a_hi, b_lo);",
             "wgmma_m64n128k8_tf32(acc[bb], a_hi, b_hi);"]
    at = [src.index(s) for s in order]
    assert at == sorted(at)
    assert src.count("cvt.rna.tf32.f32 %0, %1;") == 1  # every split goes through tf32_rna
