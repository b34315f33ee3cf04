"""The wgmma_f32 route of the z-band kernels (sps_torch/csrc/
zband_conv_tf32x3_sm90.cu: f32 on 3xTF32 wgmma) on the CPU: the route rule,
the kernel's shared-memory plan and its copies and descriptors, replayed on
seeded numpy buffers.

`zband_conv.route` sends an f32 call to "wgmma_f32" at the shapes the bf16
wgmma routes take (k = 3 with C % 32 == 0; the unfused k = 5 stem with
C % 8 == 0, C <= 48, which holds the C = 48 stem of DIST_FEATURE; bs = 8,
N % 128 == 0, 16-byte aligned operands) and
every other f32 call to "wmma". The `f32_*` helpers of ops/zband_conv.py
carry the .cu's formulas: the weight split (hi and lo, [tap][8-channel
chunk][n][8]), its 8 x 8 block flags, the halo's and weight's 16-byte
copies and the wgmma descriptors. The replay fills a block's buffers for
every step through those copies (TF32 rounding as cvt.rna does it,
tests/test_torch_tf32x3.py) and reads each wgmma's A and B tiles back
through its descriptor, K-major with 4-byte elements: every tile must be
the exact hi or lo slice of hz and wz it stands for, and the three
products summed over all steps must give the conv.
"""

import re

import numpy as np
import pytest
import torch
from test_torch_tf32x3 import split
from test_torch_zband_route import K5_CALLS, K5W_CALLS, WGMMA_CALLS, WMMA_CALLS, _operands

from sps_torch.ops import brick as bk
from sps_torch.ops import zband_conv as zc

SRC = zc.CSRC / "zband_conv_tf32x3_sm90.cu"


BF16_ROUTES = {**dict.fromkeys(WGMMA_CALLS, "wgmma"), **dict.fromkeys(K5_CALLS, "wgmma_k5"),
               **dict.fromkeys(K5W_CALLS, "wgmma_k5_wide")}


@pytest.mark.parametrize("call", sorted(BF16_ROUTES))
def test_route_takes_wgmma_f32(call):
    b, k, bs, c, n, fused, res = {**WGMMA_CALLS, **K5_CALLS, **K5W_CALLS}[call]
    hz, wz, rest = _operands(b, k, bs, c, n, torch.float32, fused, res)
    assert zc.route(hz, wz, k, bs, *rest) == "wgmma_f32"
    # bf16 keeps its own routes.
    hz, wz, rest = _operands(b, k, bs, c, n, torch.bfloat16, fused, res)
    assert zc.route(hz, wz, k, bs, *rest) == BF16_ROUTES[call]


@pytest.mark.parametrize("call", sorted(WMMA_CALLS))
def test_route_keeps_ragged_f32_on_wmma(call):
    b, k, bs, c, n, fused, res = WMMA_CALLS[call]
    hz, wz, rest = _operands(b, k, bs, c, n, torch.float32, fused, res)
    assert zc.route(hz, wz, k, bs, *rest) == "wmma"


def test_route_f32_needs_aligned_operands_and_f32_or_bf16():
    hz, wz, rest = _operands(2, 3, 8, 160, 128, torch.float32)
    assert zc.route(hz, wz, 3, 8, *rest) == "wgmma_f32"
    shifted = torch.zeros(hz.numel() + 1)[1:].view(hz.shape)  # 4 bytes off
    assert zc.route(shifted, wz, 3, 8, *rest) == "wmma"
    res = torch.zeros(rest[3].numel() + 2)[2:].view(rest[3].shape)  # 8 bytes off
    assert zc.route(hz, wz, 3, 8, *rest[:3], res) == "wmma"
    assert zc.route(hz.half(), wz.half(), 3, 8) == "wmma"  # the op refuses f16
    hz5, wz5, _ = _operands(2, 5, 8, 24, 128, torch.float32, fused=False)
    assert zc.route(hz5, wz5, 5, 8) == "wgmma_f32"
    assert zc.route(hz5, wz5, 5, 8, *_operands(2, 5, 8, 24, 128, torch.float32)[2]) == "wmma"
    # The C = 48 stem; C = 40 too (the f32 kernel walks C in 8-channel chunks).
    for c in (40, 48):
        hz5, wz5, _ = _operands(2, 5, 8, c, 128, torch.float32, fused=False)
        assert zc.route(hz5, wz5, 5, 8) == "wgmma_f32"
    hz5, wz5, _ = _operands(2, 5, 8, 56, 128, torch.float32, fused=False)
    assert zc.route(hz5, wz5, 5, 8) == "wmma"
    assert "C % 8 == 0 && C <= 48" in SRC.read_text()


def test_route_registry():
    assert zc.ROUTES["wgmma_f32"] == 3
    assert zc.ROUTE_SOURCES["wgmma_f32"] == SRC
    assert SRC in zc.CUDA_SOURCES and set(zc.ROUTE_SOURCES) == set(zc.ROUTES)
    assert '#include "sm90_wgmma.cuh"' in SRC.read_text()
    op = zc.OP_SOURCE.read_text()
    assert "route == 3" in op and "sps_zband_conv_tf32x3_sm90(" in op
    # The op's scratch: the split weight, then one int flag per 8 x 8 block.
    assert "2 * k * k * c * n + k * k * (c / 8) * (n / 8)" in op


def test_plan_matches_the_kernel_source():
    src = SRC.read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    for name, value in (("BS", 8), ("BN", zc.F32_BN), ("BRICKS", zc.F32_BRICKS),
                        ("NT", zc.F32_THREADS), ("CK", zc.F32_CK)):
        assert int(consts[name]) == value, name
    assert "STEP_TAPS = KS == 3 ? TAPS : KS" in src
    assert "static_assert(SMEM <= 232448" in src and zc.SMEM_LIMIT == 232448
    # k = 3: two halo sets of 4 bricks x (hi, lo) x 3,200 bytes and two
    # weight sets of 9 taps x (hi, lo) x 4,096; k = 5 (h = 12): 4,608-byte
    # halos and one row of 5 taps a step.
    p3, p5 = zc.f32_smem_plan(3), zc.f32_smem_plan(5)
    assert p3["smem_bytes"] == 2 * 25600 + 2 * 73728 == 198656
    assert p5["smem_bytes"] == 2 * 36864 + 2 * 40960 == 155648
    assert (p3["steps"], p3["step_taps"], p5["steps"], p5["step_taps"]) == (1, 9, 5, 5)
    for p in (p3, p5):
        assert p["smem_bytes"] <= zc.SMEM_LIMIT
        # The epilogue stages each warpgroup's 128 rows of 528 bytes in the freed buffers.
        assert zc.F32_BRICKS * 64 * (4 * zc.F32_BN + 16) <= p["smem_bytes"]


def test_kernel_step_order():
    """Within a step: the barrier, then step s+1's weight copies and halo
    loads, then step s's wgmmas, then the halo's split and store, then the
    wait for the wgmmas (the buffers step s+1 writes are those step s-1
    read; tests below replay which)."""
    src = SRC.read_text()
    loop = src[src.index("for (int s = 0; s < nsteps; ++s)"):src.index("// Accumulator layout")]
    marks = ["__syncthreads();", "load_weights<KS>(", "load_halo<KS>(", "wgmma_m64n128k8_tf32(",
             "wgmma.commit_group", "store_halo<KS>(", "wgmma.wait_group.sync.aligned 0"]
    at = [loop.index(m) for m in marks]
    assert at == sorted(at), marks


@pytest.mark.parametrize("k,c", [(3, 32), (5, 24), (5, 48)])
def test_buffers_written_are_not_read_in_the_same_step(k, c):
    p = zc.f32_smem_plan(k)
    nsteps = c // zc.F32_CK * p["steps"]
    assert nsteps == {32: 4, 24: 15, 48: 30}[c]
    for s in range(nsteps):
        q, q1 = s // p["steps"], (s + 1) // p["steps"]
        reads = {("w", s % 2), ("h", q % 2)}
        writes = set()
        if s + 1 < nsteps:
            writes.add(("w", (s + 1) % 2))
            if q1 != q:
                writes.add(("h", q1 % 2))
        assert not reads & writes, s


def _split_weight(wz):
    """zband_tf32x3_split_kernel's output on numpy: the split weight
    (hi part, then lo) and the block flags."""
    k, _, c, n = wz.shape
    hi, lo = split(wz)
    out = np.full(2 * wz.size, np.nan, np.float32)
    flags = np.zeros(k * k * (c // 8) * (n // 8), np.int32)
    for tap in range(k * k):
        for ci in range(c):
            for ni in range(n):
                o = zc.f32_split_offset(tap, ci, ni, c, n)
                out[o] = hi[tap // k, tap % k, ci, ni]
                out[wz.size + o] = lo[tap // k, tap % k, ci, ni]
                if wz[tap // k, tap % k, ci, ni] != 0:
                    flags[zc.f32_block_flag(tap, ci, ni, c, n)] = 1
    assert not np.isnan(out).any()
    return out, flags


def _buffers(hz, wsplit, flags, b0, n0, k, c, n):
    """The block's shared memory (4-byte elements) after every step's copies,
    as a list of (step, buffer) views: each step's halo and weight sets
    filled by the kernel's copies for it."""
    b, h = hz.shape[0], hz.shape[1]
    p = zc.f32_smem_plan(k)
    hz_hi, hz_lo = split(hz)
    smem = np.full(p["smem_bytes"] // 4, np.nan, np.float32)
    nsteps = c // zc.F32_CK * p["steps"]
    out = []
    for s in range(nsteps):
        q = s // p["steps"]
        if s % p["steps"] == 0:  # a chunk's halo, into halo set q % 2
            base = (q % 2) * p["halo_set"]
            for i in range(zc.F32_BRICKS * h * h * 2):
                brick, src, dst_hi, dst_lo = zc.f32_halo_piece(i, c, q, k)
                ok = b0 + brick < b
                for part, dst in ((hz_hi, base + dst_hi), (hz_lo, base + dst_lo)):
                    assert dst % 16 == 0
                    smem[dst // 4 : dst // 4 + 4] = (part.reshape(-1)[b0 * h * h * c + src :][:4]
                                                      if ok else 0.0)
        base = p["w_offset"] + (s % 2) * p["w_set"]
        for i in range(2 * p["step_taps"] * 256):
            src, dst, flag = zc.f32_weight_piece(i, s, c, n, n0, k)
            assert dst % 16 == 0 and dst < p["w_set"]
            smem[(base + dst) // 4 : (base + dst) // 4 + 4] = (wsplit[src : src + 4] if flags[flag]
                                                               else 0.0)
        out.append((s, smem.copy()))
    return out


def _tile(smem, start, lbo, sbo, rows):
    """A wgmma operand through its descriptor: K-major (rows x 8), TF32,
    core matrices of 8 rows x 16 bytes (4 elements)."""
    r, kk = np.meshgrid(np.arange(rows), np.arange(8), indexing="ij")
    byte = start + (r // 8) * sbo + (r % 8) * 16 + (kk // 4) * lbo + (kk % 4) * 4
    assert start % 16 == 0 and lbo % 16 == 0 and sbo % 16 == 0
    assert start < 2**18 and lbo >> 4 < 2**14 and sbo >> 4 < 2**14
    return smem[byte // 4]


# (B, k, TCin, TCout or N for a random weight, band-packed): K3's and the
# stem's band shapes at a reduced B, a ragged B, two column tiles, random
# weights, and the C = 48 stem of DIST_FEATURE (TCin 4; its 30 steps).
REPLAYS = [(4, 3, 4, 16, True), (3, 3, 4, 256, False), (6, 5, 2, 16, True),
           (2, 5, 2, 128, False), (3, 5, 4, 16, True)]


@pytest.mark.parametrize("b,k,tcin,tcout,band", REPLAYS)
def test_descriptors_address_the_split_halo_and_weight(b, k, tcin, tcout, band):
    rng = np.random.default_rng(b * k + tcin)
    bs, h = 8, 8 + k - 1
    c = h * tcin
    hz = rng.random((b, h, h, c), dtype=np.float32)
    if band:
        w = rng.standard_normal((k, k, k, tcin, tcout)).astype(np.float32)
        wz = bk.pack_zband_kernel(torch.from_numpy(w), bs, k // 2).numpy()
    else:
        wz = rng.standard_normal((k, k, c, tcout)).astype(np.float32)
    n = wz.shape[-1]
    wsplit, flags = _split_weight(wz)
    hz_parts, wz_parts = split(hz), split(wz)
    p = zc.f32_smem_plan(k)
    want = sum(hz[:, kx : kx + bs, ky : ky + bs].astype(np.float64) @ wz[kx, ky]
               for kx in range(k) for ky in range(k))
    for n0 in range(0, n, zc.F32_BN):
        acc = np.zeros((b, bs * bs, zc.F32_BN))
        for b0 in range(0, b, zc.F32_BRICKS):
            for s, smem in _buffers(hz, wsplit, flags, b0, n0, k, c, n):
                q, r = divmod(s, p["steps"])
                cs = slice(q * zc.F32_CK, (q + 1) * zc.F32_CK)
                for tap in range(r * p["step_taps"], (r + 1) * p["step_taps"]):
                    kx, ky = divmod(tap, k)
                    for brick in range(zc.F32_BRICKS):
                        for pa, pb in ((1, 0), (0, 1), (0, 0)):  # lo*hi, hi*lo, hi*hi
                            (sa, la, ma), (sb, lb, mb) = zc.f32_descriptors(brick, tap, s, pa,
                                                                            pb, k)
                            a = _tile(smem, sa, la, ma, bs * bs)
                            wt = _tile(smem, sb, lb, mb, zc.F32_BN)  # (N, K): K-major B
                            np.testing.assert_array_equal(
                                wt.T, wz_parts[pb][kx, ky, cs, n0 : n0 + zc.F32_BN])
                            if b0 + brick < b:
                                np.testing.assert_array_equal(
                                    a, hz_parts[pa][b0 + brick, kx : kx + bs, ky : ky + bs, cs]
                                    .reshape(bs * bs, zc.F32_CK))
                                acc[b0 + brick] += a.astype(np.float64) @ wt.T.astype(np.float64)
                            else:
                                assert not a.any()  # a missing brick is zeros
        np.testing.assert_allclose(acc.reshape(b, bs, bs, zc.F32_BN),
                                   want[..., n0 : n0 + zc.F32_BN], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k,tcin,skipped", [(3, 16, 0.70), (5, 2, 1 / 3), (5, 4, 0.5)])
def test_block_flags_skip_the_band_zeros(k, tcin, skipped):
    """At K2 / K3's band (C = 160, N = 128) 70% of the 8 x 8 weight blocks
    are zero and are zero-filled without a read; at the stem's (C = 24) a
    third; at the DIST_FEATURE stem's (C = 48) half."""
    rng = np.random.default_rng(k)
    w = rng.standard_normal((k, k, k, tcin, 16)).astype(np.float32)
    wz = bk.pack_zband_kernel(torch.from_numpy(w), 8, k // 2).numpy()
    _, flags = _split_weight(wz)
    assert 1 - flags.mean() == pytest.approx(skipped, abs=1e-9)
