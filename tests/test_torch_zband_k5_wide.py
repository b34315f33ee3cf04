"""The wgmma_k5_wide kernel's geometry on the CPU (no JAX): the k = 5 stem
at C = 48 (sps_torch/csrc/zband_conv_k5_wide_sm90.cu), the stem of
DIST_FEATURE.

The kernel keeps a 64-column tile of all 25 taps' weights resident in a
persistent block, streams each warpgroup's bricks through a ring of two
halo slots, flags the k-steps of the tile whose weight holds a value other
than +-0 at some tap and multiplies only those. The helpers below carry
the .cu's formulas (its constants read from the source); the tests replay
the copies, the flag scan and the descriptors on seeded numpy buffers:
every A and B tile must be the exact slice of hz and wz it stands for, the
flags must be the k-steps of wz that are not all zero, and the flagged
tiles must sum to the conv."""

import re

import numpy as np
import pytest
import torch
from test_torch_zband_route import _tile

from sps_torch.ops import brick as bk
from sps_torch.ops import zband_conv as zc

SRC = zc.CSRC / "zband_conv_k5_wide_sm90.cu"
K, BS, H = 5, 8, 12
# The kernel's tile: channels, columns per block, warpgroups (one brick each
# at a time), halo slots per warpgroup; 8-channel groups of a halo and a tap.
CONSTS = {n: int(v) for n, v in re.findall(r"constexpr int (\w+) = (\d+);", SRC.read_text())}
C, BN, WGS, SLOTS = (CONSTS[n] for n in ("C", "BN", "WGS", "SLOTS"))
GROUPS = C // 8


def _plan() -> dict[str, int]:
    """The kernel's shared memory, in bytes: the block's 64-column tile of
    all 25 taps' weights as MN-major core matrices [8-channel group][8-column
    group][8][8] (b_sbo: next 8 columns; b_lbo: next 8 channels; 6 groups a
    tap), then each warpgroup's two halo slots, a brick's halo as K-major
    core matrices [8-channel group][pixel][8 channels] (a_sbo: next 8 output
    rows, i.e. the next xo; a_lbo: next 8 channels), then each warpgroup's
    64 staging rows of srow bytes, then one int flag per k-step."""
    a_lbo, b_sbo = H * H * 16, 8 * 16
    b_lbo = BN // 8 * b_sbo
    halo = GROUPS * a_lbo
    w_tap = GROUPS * b_lbo
    halo_offset = K * K * w_tap
    srow = 2 * BN + 16
    stage = halo_offset + WGS * SLOTS * halo
    flags = stage + WGS * BS * BS * srow
    return dict(a_sbo=H * 16, a_lbo=a_lbo, halo_bytes=halo, b_sbo=b_sbo, b_lbo=b_lbo,
                w_tap_bytes=w_tap, halo_offset=halo_offset, srow=srow, stage_offset=stage,
                flag_offset=flags, smem_bytes=flags + GROUPS // 2 * 4)


def _descriptors(wg: int, slot: int, kx: int, ky: int, ks: int):
    """(start, lbo, sbo) in bytes from the buffer's base of the A and B
    operands of one wgmma: warpgroup wg's halo slot `slot`, tap (kx, ky),
    k-step ks (channel groups 2*ks, 2*ks + 1)."""
    p = _plan()
    a = (p["halo_offset"] + (wg * SLOTS + slot) * p["halo_bytes"] + ks * 2 * p["a_lbo"]
         + (kx * H + ky) * 16, p["a_lbo"], p["a_sbo"])
    b = ((kx * K + ky) * p["w_tap_bytes"] + ks * 2 * p["b_lbo"], p["b_lbo"], p["b_sbo"])
    return a, b


def _halo_piece(i: int):
    """(element offset into hz from the brick's first element, byte offset
    from the slot's base) of the halo's 16-byte copy i (load_halo): channel
    group i % 6 of pixel i / 6."""
    pix, g = divmod(i, GROUPS)
    return i * 8, g * _plan()["a_lbo"] + pix * 16


def _weight_piece(i: int, n: int, n0: int):
    """(element offset into wz, byte offset from the buffer's base) of the
    weight's 16-byte copy i (load_weights): column group i % 8 of channel
    row (i // 8) % 48 of tap i // 384."""
    p = _plan()
    tap, e = divmod(i, C * (BN // 8))
    ch, j = e >> 3, e & 7
    return ((tap * C + ch) * n + n0 + j * 8,
            tap * p["w_tap_bytes"] + (ch >> 3) * p["b_lbo"] + j * p["b_sbo"] + (ch & 7) * 16)


def _flag_piece(i: int):
    """(tap, k-step, byte offset from the buffer's base) of the weight's
    16-byte piece i that the flag scan reads: a k-step is multiplied when
    one of its pieces, at any of the 25 taps (128 pieces a tap), holds a
    value other than +-0."""
    tap, rest = divmod(i, GROUPS // 2 * 128)
    ks = rest >> 7
    p = _plan()
    return tap, ks, tap * p["w_tap_bytes"] + ks * 2 * p["b_lbo"] + (rest & 127) * 16


def _grid(b: int, n: int, sms: int) -> tuple[int, int]:
    """The launch's grid: (blocks a column tile, column tiles); one block an
    SM, and no more blocks than warpgroups have bricks."""
    tiles = n // BN
    return min(max(sms // tiles, 1), (b + WGS - 1) // WGS), tiles


def _bricks(b: int, blocks: int, x: int, wg: int) -> range:
    """The bricks that warpgroup wg of block x takes, in order."""
    return range(x * WGS + wg, b, blocks * WGS)


def test_plan_matches_the_kernel_source():
    src = SRC.read_text()
    assert (CONSTS["KS"], CONSTS["BS"]) == (K, BS) and "H = BS + KS - 1" in src
    assert C == C and (BN, WGS, SLOTS) == (64, 2, 2)
    assert "GROUPS = C / 8" in src and "NT = 128 * WGS" in src
    assert f"SMEM_BYTES <= {zc.SMEM_LIMIT}" in src
    assert '#include "sm90_wgmma.cuh"' in src
    # The entry point takes the route's shapes and no others: C = 48, N % 128 == 0.
    assert "channels != C" in src and "N % 128 != 0" in src
    assert zc.ROUTES["wgmma_k5_wide"] == 4 and zc.ROUTE_SOURCES["wgmma_k5_wide"] == SRC
    assert SRC in zc.CUDA_SOURCES
    op = zc.OP_SOURCE.read_text()
    assert "route == 4" in op and "sps_zband_conv_k5_wide_sm90(" in op
    # Its TPU kernel is named at the head of the source.
    assert "sps_tpu/ops/pallas_conv.py:218" in src


def test_smem_budget():
    p = _plan()
    assert (p["a_sbo"], p["a_lbo"], p["b_sbo"], p["b_lbo"]) == (192, 2304, 128, 1024)
    # 25 taps x 6 groups x 1024 bytes of weight, 2 warpgroups x 2 slots x
    # 13,824-byte halos, 2 x 64 staging rows of 144 bytes, 3 int flags.
    assert p["halo_offset"] == 25 * 6 * 1024 == 153600
    assert p["stage_offset"] - p["halo_offset"] == 4 * 13824
    assert p["flag_offset"] - p["stage_offset"] == 2 * 64 * 144
    assert p["smem_bytes"] == 227340 <= zc.SMEM_LIMIT
    # Every descriptor's start and offsets fit their fields.
    for wg in range(WGS):
        for slot in range(SLOTS):
            for kx in range(K):
                for ky in range(K):
                    for ks in range(3):
                        for start, lbo, sbo in _descriptors(wg, slot, kx, ky, ks):
                            assert start % 16 == 0 and lbo % 16 == 0 and sbo % 16 == 0
                            assert start < 2**18 and lbo >> 4 < 2**14 and sbo >> 4 < 2**14
    # The staging rows of a warp's 8 rows start on distinct banks (4 words apart).
    assert sorted((r * p["srow"] // 4) % 32 for r in range(8)) == list(range(0, 32, 4))


def _weight_buffer(wz, n0):
    """The block's weight after load_weights for columns n0 .. n0+63 (2-byte
    elements); each byte is written once."""
    c, n = wz.shape[2], wz.shape[3]
    smem = np.full(_plan()["halo_offset"] // 2, np.nan, np.float32)
    wz_flat = wz.reshape(-1)
    for i in range(K * K * c * BN // 8):
        src, dst = _weight_piece(i, n, n0)
        assert dst % 16 == 0 and np.isnan(smem[dst // 2 : dst // 2 + 8]).all()
        smem[dst // 2 : dst // 2 + 8] = wz_flat[src : src + 8]
    return smem


def _flags(wbuf):
    """The kernel's flag scan on the weight buffer: one bool a k-step."""
    flags = np.zeros(3, bool)
    seen = np.zeros((K * K, 3), int)
    for i in range(K * K * 3 * 128):
        tap, ks, off = _flag_piece(i)
        piece = wbuf[off // 2 : off // 2 + 8]
        assert not np.isnan(piece).any()  # the scan reads only copied bytes
        flags[ks] |= bool((piece != 0).any())
        seen[tap, ks] += 1
    assert (seen == 128).all()  # every tap's 16 x 64 block of every k-step
    return flags


def _halo_slot(hz, b):
    """One halo slot after load_halo for brick b (2-byte elements)."""
    c = hz.shape[-1]
    slot = np.full(_plan()["halo_bytes"] // 2, np.nan, np.float32)
    flat = hz[b].reshape(-1)
    for i in range(H * H * c // 8):
        src, dst = _halo_piece(i)
        assert dst % 16 == 0 and np.isnan(slot[dst // 2 : dst // 2 + 8]).all()
        slot[dst // 2 : dst // 2 + 8] = flat[src : src + 8]
    return slot


def _band_wz(rng, tcin=4, tcout=16):
    w = rng.standard_normal((K, K, K, tcin, tcout)).astype(np.float32)
    return bk.pack_zband_kernel(torch.from_numpy(w), BS, K // 2).numpy()


# (B, N, band-packed): the DIST_FEATURE stem's band at a reduced B, a dense
# random weight, two column tiles.
REPLAYS = [(3, 128, True), (2, 128, False), (1, 256, False)]


def _kernel_out(hz, wz):
    """The kernel's output (B, 64, N) replayed in f64: each column tile's
    weight buffer and k-step flags, each brick's halo slot, and the wgmmas of
    the flagged k-steps through their descriptors. Every A and B tile is
    held to its hz or wz slice, every skipped k-step to zeros in wz."""
    b, n = hz.shape[0], wz.shape[-1]
    p = _plan()
    out = np.zeros((b, 64, n))
    for n0 in range(0, n, BN):
        wbuf = _weight_buffer(wz, n0)
        flags = _flags(wbuf)
        cols = slice(n0, n0 + BN)
        for brick in range(b):
            wg, slot = brick % WGS, brick // WGS % SLOTS
            smem = np.concatenate([wbuf, np.full(p["smem_bytes"] // 2 - wbuf.size, np.nan,
                                                 np.float32)])
            base = (p["halo_offset"] + (wg * SLOTS + slot) * p["halo_bytes"]) // 2
            halo = _halo_slot(hz, brick)
            smem[base : base + halo.size] = halo
            for kx in range(K):
                for ky in range(K):
                    for ks in range(3):
                        ch = slice(16 * ks, 16 * ks + 16)
                        if not flags[ks]:
                            assert not wz[kx, ky, ch, cols].any()  # skipped: all zero
                            continue
                        (sa, la, ma), (sb, lb, mb) = _descriptors(wg, slot, kx, ky, ks)
                        a = _tile(smem, sa, la, ma, 64, mn_major=False)
                        w = _tile(smem, sb, lb, mb, BN, mn_major=True)
                        np.testing.assert_array_equal(w, wz[kx, ky, ch, cols])
                        np.testing.assert_array_equal(
                            a, hz[brick, kx : kx + BS, ky : ky + BS, ch].reshape(64, 16))
                        out[brick, :, cols] += a.astype(np.float64) @ w
    return out


@pytest.mark.parametrize("b,n,band", REPLAYS)
def test_descriptors_address_the_halo_and_weight(b, n, band):
    """Every A and B tile of the flagged k-steps is its hz or wz slice;
    an unflagged k-step is all zero in wz at every tap; the flagged tiles sum
    to the conv."""
    rng = np.random.default_rng(b * C + n)
    hz = rng.standard_normal((b, H, H, C)).astype(np.float32)
    wz = _band_wz(rng) if band else rng.standard_normal((K, K, C, n)).astype(np.float32)
    want = sum(hz[:, kx : kx + BS, ky : ky + BS].reshape(b, 64, C).astype(np.float64) @ wz[kx, ky]
               for kx in range(K) for ky in range(K))
    np.testing.assert_allclose(_kernel_out(hz, wz), want, rtol=1e-12, atol=1e-12)


def test_a_skipped_k_step_leaves_a_non_finite_halo_value_out():
    """The kernel's result where the halo holds an Inf or a NaN, as its
    source's note on the band's zeros states: a skipped k-step forms no
    product, so a non-finite value in halo z that only skipped k-steps read
    does not reach that column tile, whose outputs stay finite and equal the
    conv of the halo with the value set to 0. A tile that multiplies that
    k-step is non-finite there, as the plain version is in every column (0 x
    Inf is NaN; so is the wgmma_f32 route, which zero-fills a zero block but
    still multiplies it)."""
    rng = np.random.default_rng(19)
    b, n = 3, 128
    hz = rng.standard_normal((b, H, H, C)).astype(np.float32)
    wz = _band_wz(rng)
    # Channels 32..47 are halo z 8..11, k-step 2: column tile 0 (output z
    # 0..3) skips it, tile 1 (output z 4..7) multiplies it.
    hz[0, 5, 6, 40] = np.inf
    hz[2, 11, 0, 33] = np.nan
    with np.errstate(invalid="ignore"):
        got = _kernel_out(hz, wz)

    def plain(h):
        out = zc.zband_conv(torch.from_numpy(h), torch.from_numpy(wz), K, BS)
        return out.reshape(b, 64, n).numpy()

    want, clean = plain(hz), plain(np.nan_to_num(hz, nan=0.0, posinf=0.0))
    hit = ~np.isfinite(want)
    assert (hit.any(axis=-1) == hit.all(axis=-1)).all() and hit.any(axis=-1).sum() > 1
    assert np.isfinite(got[..., :BN]).all()
    np.testing.assert_allclose(got[..., :BN], clean[..., :BN], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(~np.isfinite(got[..., BN:]), hit[..., BN:])
    np.testing.assert_allclose(got[..., BN:][~hit[..., BN:]], clean[..., BN:][~hit[..., BN:]],
                               rtol=1e-5, atol=1e-5)


def test_flags_are_the_band_blocks_of_wz():
    """At the DIST_FEATURE stem's band (TCin 4, C = 48, N = 128) a k-step of
    a column tile is flagged exactly where one of its 8 x 8 blocks of
    pack_zband_kernel(w, 8, 2), at some tap, is not all zero: a third of
    the k-steps are skipped (half the 8 x 8 blocks are zero); on a dense wz
    none."""
    rng = np.random.default_rng(0)
    wz = _band_wz(rng)
    blocks = wz.reshape(K * K, 6, 8, 16, 8).any(axis=(2, 4))  # [tap][8-ch group][8-col group]
    assert 1 - blocks.mean() == pytest.approx(0.5)
    skipped = []
    for t, n0 in enumerate(range(0, 128, BN)):
        flags = _flags(_weight_buffer(wz, n0))
        want = blocks[:, :, 8 * t : 8 * t + 8].reshape(K * K, 3, 2, 8).any(axis=(0, 2, 3))
        np.testing.assert_array_equal(flags, want)
        skipped.append(1 - flags.mean())
        # Output z 0..3 read halo z 0..7 (k-steps 0, 1), z 4..7 halo z 4..11 (1, 2).
        assert flags.tolist() == ([True, True, False] if t == 0 else [False, True, True])
    assert np.mean(skipped) == pytest.approx(1 / 3)
    dense = rng.standard_normal((K, K, 48, 128)).astype(np.float32)
    assert _flags(_weight_buffer(dense, 64)).all()
    # One value other than 0 at one tap flags its k-step.
    one = np.zeros_like(wz)
    one[4, 1, 40, 70] = 1.0
    assert _flags(_weight_buffer(one, 64)).tolist() == [False, False, True]
    assert not _flags(_weight_buffer(one, 0)).any()
    # -0.0 is a zero: a block of -0.0 is skipped as the kernel's sign mask does.
    neg = np.where(wz == 0, -0.0, wz).astype(np.float32)
    np.testing.assert_array_equal(_flags(_weight_buffer(neg, 0)), _flags(_weight_buffer(wz, 0)))


@pytest.mark.parametrize("b,n", [(1, 128), (7, 128), (11263, 128), (11264, 128), (535, 256)])
def test_schedule_takes_every_brick_once(b, n):
    """The persistent blocks' warpgroups take every brick of every column
    tile exactly once, balanced within one brick."""
    blocks, tiles = _grid(b, n, 132)
    assert tiles == n // BN and blocks * tiles <= max(132, tiles)
    taken = [list(_bricks(b, blocks, x, wg))
             for x in range(blocks) for wg in range(WGS)]
    assert sorted(i for t in taken for i in t) == list(range(b))
    counts = [len(t) for t in taken]
    assert max(counts) - min(counts) <= 1 and min(counts) >= (0 if b < 2 * blocks else 1)


def test_kernel_step_order():
    """The weight and its k-step flags before the brick loop, which runs
    instantiated for the flags' mask; a warpgroup's step: the next brick's
    copies, the wait for this brick's, its barrier, the wgmmas, their wait,
    the results; the results staged, their barrier, the stores."""
    src = SRC.read_text()

    def in_order(body, marks):
        at, pos = [], 0
        for m in marks:
            pos = body.index(m, pos)
            at.append(pos)
        assert at == sorted(at)

    kernel = src[src.index("zband_k5_wide_kernel(const Params p)"):]
    in_order(kernel, ["load_weights(p,", "cp.async.wait_group 1", "__syncthreads();",
                      "flags[ks] = 1", "__syncthreads();", "switch (kmask)"])
    assert all(f"run_bricks<{m}>(" in kernel for m in range(8))
    loop = src[src.index("void run_bricks("):src.index("zband_k5_wide_kernel(const Params p)")]
    in_order(loop, ["for (int it = 0; b < p.B;", "load_halo(p,", "cp.async.wait_group 1",
                    "bar.sync %0, 128", "issue_brick<KMASK>(", "wgmma.commit_group",
                    "wgmma.wait_group.sync.aligned 0", "store_brick(p, acc"])
    store = src[src.index("void store_brick("):src.index("void run_bricks(")]
    in_order(store, ["__floats2bfloat162_rn", "bar.sync %0, 128", "*reinterpret_cast<uint4*>(p.out"])
    # No branch inside a brick's wgmma sequence: the mask is a template argument.
    issue = src[src.index("void issue_brick("):src.index("void store_brick(")]
    assert "if ((KMASK >> ks) & 1)" in issue and "mask[" not in issue
