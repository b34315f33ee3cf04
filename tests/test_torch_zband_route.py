"""The z-band kernels' route and the wgmma kernels' shared-memory plans, on
the CPU.

`zband_conv.route` picks, from a call's shape alone, the kernel a CUDA
tensor runs: the wgmma kernel (sps_torch/csrc/zband_conv_sm90.cu) for the
L0 block8 convs and the k = 3 microbenchmark, the k = 5 wgmma kernel
(zband_conv_k5_sm90.cu) for the stem, the wide k = 5 wgmma kernel
(zband_conv_k5_wide_sm90.cu, tests/test_torch_zband_k5_wide.py) for the
C = 48 stem of DIST_FEATURE, in f32 at those shapes the 3xTF32 wgmma
kernel (zband_conv_tf32x3_sm90.cu, tests/test_torch_zband_f32_route.py),
the WMMA kernel (zband_conv.cu) for everything else. The wgmma kernels
read their operands out of shared memory through descriptors; the `sm90_*`
and `k5_*` helpers carry the same formulas as the .cu files, and the tests
replay the copies and descriptors on seeded numpy buffers: every A and B
tile must come out as the exact slice of hz and wz it stands for."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from sps_torch.ops import zband_conv as zc


def _operands(b, k, bs, c, n, dtype=torch.bfloat16, fused=True, res=True):
    h = bs + k - 1
    hz = torch.zeros((b, h, h, c), dtype=dtype)
    wz = torch.zeros((k, k, c, n), dtype=dtype)
    if not fused:
        return hz, wz, ()
    occ = torch.zeros((b, bs, bs, n), dtype=dtype)
    rest = (torch.ones(n), torch.zeros(n), occ, torch.zeros_like(occ) if res else None)
    return hz, wz, rest


# (b, k, bs, C, N, fused, res): the main path's calls and K3's.
WGMMA_CALLS = {
    "block8_0.conv1": (2, 3, 8, 320, 128, True, False),
    "block8_0.conv2": (2, 3, 8, 160, 128, True, True),
    "K3 TC 16": (2, 3, 8, 160, 128, False, False),
    "K3 TC 32": (2, 3, 8, 320, 256, False, False),
}
# chip_smoke.py phase 2's small shapes: (k, bs, tcin, tcout, B).
SMALL = [(3, 4, 2, 3, 8), (3, 8, 2, 2, 8), (5, 4, 1, 2, 8), (3, 4, 2, 2, 6), (3, 4, 2, 2, 4)]
# The stem (C = 24) and the other unfused k = 5 shapes the k = 5 kernel takes.
K5_CALLS = {
    "stem k=5": (2, 5, 8, 24, 128, False, False),
    "k=5 C=16": (3, 5, 8, 16, 128, False, False),
    "k=5 C=8": (1, 5, 8, 8, 128, False, False),
    "k=5 N=256": (5, 5, 8, 24, 256, False, False),
}
# The stem of DIST_FEATURE (C = 48), which the wide k = 5 kernel takes.
K5W_CALLS = {
    "stem C=48 (DIST_FEATURE)": (2, 5, 8, 48, 128, False, False),
    "k=5 C=48 B=7": (7, 5, 8, 48, 128, False, False),
    "k=5 C=48 N=256": (1, 5, 8, 48, 256, False, False),
}
WMMA_CALLS = {
    "stem fused": (2, 5, 8, 24, 128, True, True),
    "stem C=48 fused": (2, 5, 8, 48, 128, True, False),
    "k=5 C=56": (2, 5, 8, 56, 128, False, False),
    "k=5 C % 8 != 0": (2, 5, 8, 12, 128, False, False),
    "k=5 bs=4": (2, 5, 4, 24, 128, False, False),
    "k=5 N=64": (2, 5, 8, 24, 64, False, False),
    "C % 32 != 0": (2, 3, 8, 168, 128, True, True),
    "N = 64": (2, 3, 8, 160, 64, True, True),
    **{f"small k={k} bs={bs} tcin={ti} tcout={to} B={b}": (b, k, bs, (bs + k - 1) * ti, bs * to,
                                                           True, True)
       for k, bs, ti, to, b in SMALL},
}


@pytest.mark.parametrize("call", sorted(WGMMA_CALLS))
def test_route_takes_wgmma(call):
    b, k, bs, c, n, fused, res = WGMMA_CALLS[call]
    hz, wz, rest = _operands(b, k, bs, c, n, fused=fused, res=res)
    assert zc.route(hz, wz, k, bs, *rest) == "wgmma"
    # f32 operands of the same shape take the 3xTF32 wgmma kernel.
    hz32, wz32, rest32 = _operands(b, k, bs, c, n, torch.float32, fused, res)
    assert zc.route(hz32, wz32, k, bs, *rest32) == "wgmma_f32"


@pytest.mark.parametrize("call", sorted(K5_CALLS))
def test_route_takes_wgmma_k5(call):
    b, k, bs, c, n, fused, res = K5_CALLS[call]
    hz, wz, rest = _operands(b, k, bs, c, n, fused=fused, res=res)
    assert zc.route(hz, wz, k, bs, *rest) == "wgmma_k5"
    # f32 operands of the same shape take the 3xTF32 wgmma kernel.
    hz32, wz32, rest32 = _operands(b, k, bs, c, n, torch.float32, fused, res)
    assert zc.route(hz32, wz32, k, bs, *rest32) == "wgmma_f32"


@pytest.mark.parametrize("call", sorted(K5W_CALLS))
def test_route_takes_wgmma_k5_wide(call):
    b, k, bs, c, n, fused, res = K5W_CALLS[call]
    hz, wz, rest = _operands(b, k, bs, c, n, fused=fused, res=res)
    assert zc.route(hz, wz, k, bs, *rest) == "wgmma_k5_wide"
    # f32 operands of the same shape take the 3xTF32 wgmma kernel.
    hz32, wz32, rest32 = _operands(b, k, bs, c, n, torch.float32, fused, res)
    assert zc.route(hz32, wz32, k, bs, *rest32) == "wgmma_f32"


@pytest.mark.parametrize("call", sorted(WMMA_CALLS))
def test_route_keeps_wmma(call):
    b, k, bs, c, n, fused, res = WMMA_CALLS[call]
    for dtype in (torch.bfloat16, torch.float32):
        hz, wz, rest = _operands(b, k, bs, c, n, dtype, fused, res)
        assert zc.route(hz, wz, k, bs, *rest) == "wmma"


def test_route_needs_aligned_operands():
    hz, wz, rest = _operands(2, 3, 8, 160, 128)
    assert zc.route(hz, wz, 3, 8, *rest) == "wgmma"
    # The same shape at an offset of one element (2 bytes) into a buffer.
    shifted = torch.zeros(hz.numel() + 1, dtype=hz.dtype)[1:].view(hz.shape)
    assert shifted.data_ptr() % 16 != 0
    assert zc.route(shifted, wz, 3, 8, *rest) == "wmma"
    occ = torch.zeros(rest[2].numel() + 1, dtype=hz.dtype)[1:].view(rest[2].shape)
    assert zc.route(hz, wz, 3, 8, rest[0], rest[1], occ, rest[3]) == "wmma"
    # The stem likewise.
    hz, wz, _ = _operands(2, 5, 8, 24, 128, fused=False)
    assert zc.route(hz, wz, 5, 8) == "wgmma_k5"
    shifted = torch.zeros(wz.numel() + 1, dtype=wz.dtype)[1:].view(wz.shape)
    assert zc.route(hz, shifted, 5, 8) == "wmma"
    # And the DIST_FEATURE stem.
    hz, wz, _ = _operands(2, 5, 8, 48, 128, fused=False)
    assert zc.route(hz, wz, 5, 8) == "wgmma_k5_wide"
    shifted = torch.zeros(hz.numel() + 1, dtype=hz.dtype)[1:].view(hz.shape)
    assert zc.route(shifted, wz, 5, 8) == "wmma"


def test_variants_script_needs_a_card():
    from sps_torch.scripts import zband_sm90_variants as zv

    with pytest.raises(SystemExit, match="no CUDA device"):
        zv.main([])
    assert set(zv.TIMED) >= {"block8_0.conv1", "block8_0.conv2", "K3 TC16", "K3 TC32"}


def test_reset_launches():
    zc.LAUNCHES["zband_conv"] = 3
    zc.ROUTE_LAUNCHES["zband_conv_fused"]["wgmma"] = 2
    zc.reset_launches()
    assert zc.LAUNCHES == {"zband_conv": 0, "zband_conv_fused": 0}
    assert zc.ROUTE_LAUNCHES == {name: {"wmma": 0, "wgmma": 0, "wgmma_k5": 0, "wgmma_f32": 0,
                                        "wgmma_k5_wide": 0}
                                 for name in zc.LAUNCHES}


def test_reset_launches_clears_shape_counts():
    zc.SHAPE_LAUNCHES[("zband_conv_fused", "wgmma", (8, 10, 10, 160), (3, 3, 160, 128))] = 4
    zc.reset_launches()
    assert zc.SHAPE_LAUNCHES == {}


def test_plan_matches_the_kernel_source():
    """The helpers' tile constants are the .cu's."""
    src = (zc.CSRC / "zband_conv_sm90.cu").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(consts["CK"]) == zc.SM90_CK
    assert int(consts["BN"]) == zc.SM90_BN
    assert int(consts["BRICKS"]) == zc.SM90_BRICKS
    assert int(consts["NT"]) == zc.SM90_THREADS
    assert int(consts["STAGES"]) == zc.SM90_STAGES
    assert int(consts["C_MULTIPLE"]) == zc.SM90_C_MULTIPLE
    assert f"SMEM_BYTES <= {zc.SMEM_LIMIT}" in src
    assert zc.CSRC / "zband_conv_sm90.cu" in zc.SOURCES
    assert Path(zc.CSRC / "zband_conv_op.cpp") == zc.OP_SOURCE


def test_stage_budget():
    plan = zc.sm90_smem_plan()
    assert plan["a_sbo"] == 160 and plan["a_lbo"] == 1600  # h * 16, h * h * 16 bytes
    assert plan["halo_bytes"] == zc.SM90_CK // 8 * 1600
    assert plan["stage_bytes"] == (zc.SM90_BRICKS * plan["halo_bytes"]
                                   + 9 * zc.SM90_CK * zc.SM90_BN * 2)
    assert zc.SM90_STAGES * plan["stage_bytes"] <= zc.SMEM_LIMIT


def _stage(hz, wz, b0, q, n0):
    """One stage of shared memory, as elements of 2 bytes, after the
    kernel's copies of chunk q for the block of bricks b0 .. b0+3 and
    columns n0 .. n0+127; bricks past the batch are zero-filled."""
    b, h, _, c = hz.shape
    n = wz.shape[-1]
    plan = zc.sm90_smem_plan(h)
    smem = np.full(plan["stage_bytes"] // 2, np.nan, np.float32)
    hz_flat, wz_flat = hz.reshape(-1), wz.reshape(-1)
    c0 = q * zc.SM90_CK
    for i in range(zc.SM90_BRICKS * zc.SM90_CK // 8 * h * h):
        brick, src, dst = zc.sm90_halo_piece(i, c, c0, h)
        assert dst % 16 == 0
        ok = b0 + brick < b
        smem[dst // 2 : dst // 2 + 8] = hz_flat[b0 * h * h * c + src :][:8] if ok else 0.0
    sweeps = zc.SM90_CK * zc.SM90_BN // 8 // zc.SM90_THREADS
    for tid in range(zc.SM90_THREADS):
        for it in range(sweeps * 9):
            src, dst = zc.sm90_weight_piece(tid, it, c, n, c0, n0)
            assert dst % 16 == 0
            smem[dst // 2 : dst // 2 + 8] = wz_flat[src : src + 8]
    assert not np.isnan(smem).any(), "the copies leave no byte of the stage unwritten"
    return smem


def _tile(smem, start, lbo, sbo, rows, mn_major):
    """Gather a wgmma operand through its descriptor: a K-major (rows x 16)
    tile, or an MN-major (16 x rows) one; core matrices are 8 x 16 bytes."""
    r, kk = np.meshgrid(np.arange(rows), np.arange(16), indexing="ij")
    if mn_major:  # rows along N, 8 of them contiguous; k picks the 16-byte row
        byte = start + (r // 8) * sbo + (r % 8) * 2 + (kk // 8) * lbo + (kk % 8) * 16
    else:         # rows along M, 16 bytes apart; 8 channels contiguous
        byte = start + (r // 8) * sbo + (r % 8) * 16 + (kk // 8) * lbo + (kk % 8) * 2
    assert start % 16 == 0 and (byte % 2 == 0).all()
    t = smem[byte // 2]
    return t.T if mn_major else t


@pytest.mark.parametrize("b,c,n", [(4, 160, 128), (3, 320, 256)])
def test_descriptors_address_the_halo_and_weight(b, c, n):
    rng = np.random.default_rng(c + n)
    k, bs, h = 3, 8, 10
    hz = rng.standard_normal((b, h, h, c)).astype(np.float32)
    wz = rng.standard_normal((k, k, c, n)).astype(np.float32)
    for q in (0, c // zc.SM90_CK - 1):
        for n0 in range(0, n, zc.SM90_BN):
            smem = _stage(hz, wz, 0, q, n0)
            for brick in range(zc.SM90_BRICKS):
                acc = np.zeros((bs * bs, zc.SM90_BN), np.float64)
                for kx in range(k):
                    for ky in range(k):
                        for ks in range(zc.SM90_CK // 16):
                            (sa, la, ma), (sb, lb, mb) = zc.sm90_descriptors(brick, kx, ky, ks)
                            a = _tile(smem, sa, la, ma, bs * bs, mn_major=False)
                            w = _tile(smem, sb, lb, mb, zc.SM90_BN, mn_major=True)
                            c0 = q * zc.SM90_CK + 16 * ks
                            want_w = wz[kx, ky, c0 : c0 + 16, n0 : n0 + zc.SM90_BN]
                            np.testing.assert_array_equal(w, want_w)
                            if brick < b:
                                want_a = hz[brick, kx : kx + bs, ky : ky + bs, c0 : c0 + 16]
                                np.testing.assert_array_equal(a, want_a.reshape(bs * bs, 16))
                            else:
                                assert not a.any()  # a missing brick is zeros
                            acc += a.astype(np.float64) @ w
                # The stage's 9 taps x k-steps sum to the chunk's share of the conv.
                if brick < b:
                    cs = slice(q * zc.SM90_CK, (q + 1) * zc.SM90_CK)
                    want = sum(hz[brick, kx : kx + bs, ky : ky + bs, cs].reshape(bs * bs, -1)
                               .astype(np.float64) @ wz[kx, ky, cs, n0 : n0 + zc.SM90_BN]
                               for kx in range(k) for ky in range(k))
                    np.testing.assert_allclose(acc, want, rtol=1e-12, atol=1e-12)


def test_k5_plan_matches_the_kernel_source():
    """The k = 5 helpers' tile constants are zband_conv_k5_sm90.cu's."""
    src = (zc.CSRC / "zband_conv_k5_sm90.cu").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    for name, value in (("KS", zc.K5_KS), ("BS", zc.K5_BS), ("GROUPS", zc.K5_GROUPS),
                        ("A_GROUPS", zc.K5_A_GROUPS), ("BN", zc.K5_BN),
                        ("BRICKS", zc.K5_BRICKS), ("NT", zc.K5_THREADS)):
        assert int(consts[name]) == value, name
    assert f"SMEM_BYTES <= {zc.SMEM_LIMIT}" in src
    assert '#include "sm90_wgmma.cuh"' in src
    assert zc.ROUTE_SOURCES["wgmma_k5"] == zc.CSRC / "zband_conv_k5_sm90.cu"
    assert zc.ROUTE_SOURCES["wgmma_k5"] in zc.CUDA_SOURCES
    assert zc.CSRC / "sm90_wgmma.cuh" in zc.HEADERS
    assert set(zc.ROUTE_SOURCES) == set(zc.ROUTES)


def test_k5_smem_budget():
    plan = zc.k5_smem_plan()
    assert plan["a_sbo"] == 192 and plan["a_lbo"] == 2304  # h * 16, h * h * 16 bytes at h = 12
    assert plan["halo_bytes"] == 4 * 2304
    assert plan["w_tap_bytes"] == 3 * 16 * 128  # 24 channels x 128 columns x 2 bytes
    # 6 halos + 25 taps of weight + one zeroed group of weight rows.
    assert plan["smem_bytes"] == 6 * 9216 + 25 * 6144 + 2048 == 210944
    assert plan["smem_bytes"] <= zc.SMEM_LIMIT
    # Each warpgroup holds 2 bricks; the epilogue stages their 128 rows of
    # 272 bytes each in the freed buffer.
    assert zc.K5_BRICKS == 2 * (zc.K5_THREADS // 128)
    assert zc.K5_BRICKS * 64 * (2 * zc.K5_BN + 16) <= plan["smem_bytes"]
    # Every descriptor's start and offsets fit their fields: start < 2**18
    # bytes, lbo and sbo < 2**14 units of 16 bytes, all 16-byte aligned.
    for brick in range(zc.K5_BRICKS):
        for kx in range(5):
            for ky in range(5):
                for ks in range(2):
                    for start, lbo, sbo in zc.k5_descriptors(brick, kx, ky, ks):
                        assert start % 16 == 0 and lbo % 16 == 0 and sbo % 16 == 0
                        assert start < 2**18 and lbo >> 4 < 2**14 and sbo >> 4 < 2**14


def _k5_buffer(hz, wz, b0, n0):
    """The k = 5 kernel's shared memory, as elements of 2 bytes, after its
    zero stores and all five groups of copies for the block of bricks
    b0 .. b0+5 and columns n0 .. n0+127; bricks past the batch are
    zero-filled. Each byte is written once."""
    b, h, _, c = hz.shape
    n = wz.shape[-1]
    smem = np.full(zc.k5_smem_plan()["smem_bytes"] // 2, np.nan, np.float32)

    def put(dst, values):
        assert dst % 16 == 0 and np.isnan(smem[dst // 2 : dst // 2 + 8]).all()
        smem[dst // 2 : dst // 2 + 8] = values

    for lo, hi in zc.k5_zero_ranges(c):
        for dst in range(lo, hi, 16):
            put(dst, 0.0)
    hz_flat, wz_flat = hz.reshape(-1), wz.reshape(-1)
    for i in range(zc.K5_BRICKS * h * h * c // 8):
        brick, src, dst = zc.k5_halo_piece(i, c)
        ok = b0 + brick < b
        put(dst, hz_flat[b0 * h * h * c + src :][:8] if ok else 0.0)
    for kx in range(5):
        for e in range(5 * c // 8 * zc.K5_BN):
            src, dst = zc.k5_weight_piece(e, kx, c, n, n0)
            put(dst, wz_flat[src : src + 8])
    assert not np.isnan(smem).any(), "the copies and zero stores leave no byte unwritten"
    return smem


@pytest.mark.parametrize("b,c,n", [(6, 24, 128), (3, 24, 256), (5, 16, 128), (2, 8, 128)])
def test_k5_descriptors_address_the_halo_and_weight(b, c, n):
    """Every A and B tile of all 25 taps and both k-steps is its hz or wz
    slice exactly; the halo's zero slot reads as zeros and the weight rows
    facing it are finite (zeros); the taps sum to the conv."""
    rng = np.random.default_rng(c + n + b)
    k, bs, h = 5, 8, 12
    hz = rng.standard_normal((b, h, h, c)).astype(np.float32)
    wz = rng.standard_normal((k, k, c, n)).astype(np.float32)  # not band-packed
    hz_pad = np.concatenate([hz, np.zeros((b, h, h, 32 - c), np.float32)], -1)
    wz_pad = np.concatenate([wz, np.zeros((k, k, 32 - c, n), np.float32)], 2)
    for n0 in range(0, n, zc.K5_BN):
        smem = _k5_buffer(hz, wz, 0, n0)
        cols = slice(n0, n0 + zc.K5_BN)
        for brick in range(zc.K5_BRICKS):
            acc = np.zeros((bs * bs, zc.K5_BN), np.float64)
            for kx in range(k):
                for ky in range(k):
                    for ks in range(2):
                        (sa, la, ma), (sb, lb, mb) = zc.k5_descriptors(brick, kx, ky, ks)
                        a = _tile(smem, sa, la, ma, bs * bs, mn_major=False)
                        w = _tile(smem, sb, lb, mb, zc.K5_BN, mn_major=True)
                        ch = slice(16 * ks, 16 * ks + 16)
                        np.testing.assert_array_equal(w, wz_pad[kx, ky, ch, cols])
                        if ks == 1:
                            assert not a[:, 8:].any()  # the zero slot
                            assert np.isfinite(w[8:]).all() and not w[8:].any()
                        if brick < b:
                            want_a = hz_pad[brick, kx : kx + bs, ky : ky + bs, ch]
                            np.testing.assert_array_equal(a, want_a.reshape(bs * bs, 16))
                        else:
                            assert not a.any()  # a missing brick is zeros
                        acc += a.astype(np.float64) @ w
            if brick < b:
                want = sum(hz[brick, kx : kx + bs, ky : ky + bs].reshape(bs * bs, c)
                           .astype(np.float64) @ wz[kx, ky, :, cols]
                           for kx in range(k) for ky in range(k))
                np.testing.assert_allclose(acc, want, rtol=1e-12, atol=1e-12)
