"""Port of the int8 brick conv: sps_torch.ops.brick.brick_conv_int8 (the
plain version of the brick_conv_int8 kernel on the CPU) against
sps_tpu.ops.brick.brick_conv_int8 on the same seeded features, neighbour
tables and weights; the kernel's shape rule, shared-memory plan and, on
numpy buffers, its copies and mma fragments.

The int8 path is exact up to its roundings, so the comparisons are bit for
bit. sps_tpu's function runs op by op here (as written), its halo assembly
(a pure gather) jitted to save compile time: under jit of the whole
function, XLA reassociates the dequant scale as (s_in / 127) * max|w|
instead of s_in * (max|w| / 127), which moves the scale, and so the
output, by at most an ulp; test_jitted_reference_within_an_ulp holds the
port to that.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sps_tpu.ops import brick as jbk
from sps_torch.ops import brick as tbk
from sps_torch.ops import brick_conv_int8 as bi8

SMEM_LIMIT = 232448


def _case(seed, b, bs, tcin, tcout, absent=0.3, zero=False, extreme=False, num_bricks=None):
    """Masked features (phantom slots and bricks past num_bricks exactly
    zero), a neighbour table with absent (-1) neighbours and the centre
    on itself, occupancy (T = 2) and a dense weight."""
    rng = np.random.default_rng(seed)
    nb = b if num_bricks is None else num_bricks
    occ = (rng.random((b, bs, bs, bs, 2)) < 0.4).astype(np.float32)
    occ[nb:] = 0.0
    f = rng.standard_normal((b, bs, bs, bs, 2, tcin // 2)).astype(np.float32)
    if extreme:  # every code +-127: the largest |acc|
        f = np.sign(f) + (f == 0)
    f = (f * occ[..., None]).reshape(b, bs, bs, bs, tcin)
    if zero:
        f[:] = 0.0
    nbr = rng.integers(0, b, (27, b)).astype(np.int32)
    nbr[rng.random((27, b)) < absent] = -1
    nbr[13] = np.arange(b)
    w = (rng.standard_normal((3, 3, 3, tcin, tcout)) * 0.2).astype(np.float32)
    return f, nbr, occ, w


_JIT_HALO = jax.jit(jbk.halo, static_argnums=(2,))


def _jax(f, nbr, w, occ, dtype, mask_out, monkeypatch):
    monkeypatch.setattr(jbk, "halo", _JIT_HALO)
    return np.asarray(jbk.brick_conv_int8(jnp.asarray(f, dtype), jnp.asarray(nbr), jnp.asarray(w),
                                          jnp.asarray(occ), mask_out=mask_out)).astype(np.float32)


def _torch(f, nbr, w, occ, dtype, mask_out):
    out = tbk.brick_conv_int8(torch.from_numpy(f).to(dtype), torch.from_numpy(nbr),
                              torch.from_numpy(w), torch.from_numpy(occ), mask_out=mask_out)
    assert out.dtype == dtype
    return out.float().numpy()


CASES = {  # name: (B, bs, TCin, TCout, _case options, mask_out)
    # tests/test_int8.py's shapes (cin, cout) = (8, 8), (16, 8) at T = 2.
    "bs4-16to16": (24, 4, 16, 16, {}, True),
    "bs4-32to16": (24, 4, 32, 16, {}, False),
    # The kernel's brick side, with bricks past num_bricks (zero rows).
    "bs8-32to16": (6, 8, 32, 16, {"num_bricks": 4}, False),
    "bs8-48to32-ragged3": (3, 8, 48, 32, {"absent": 0.6}, True),
    "bs8-16to16-B1": (1, 8, 16, 16, {}, False),
    "bs8-16to32-B5-allabsent": (5, 8, 16, 32, {"absent": 1.0}, False),
    "bs8-zero": (4, 8, 16, 16, {"zero": True}, True),
    "bs8-pm127": (3, 8, 32, 16, {"extreme": True}, False),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_brick_conv_int8_bit_equal_to_sps_tpu(name, dtype, monkeypatch):
    b, bs, tcin, tcout, opts, mask_out = CASES[name]
    f, nbr, occ, w = _case(len(name), b, bs, tcin, tcout, **opts)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = _jax(f, nbr, w, occ, jdt, mask_out, monkeypatch)
    got = _torch(f, nbr, w, occ, dtype, mask_out)
    np.testing.assert_array_equal(got, want)
    if opts.get("zero"):
        assert not got.any()
    if mask_out:  # phantom slots stay exactly zero
        phantom = np.repeat(occ, tcout // 2, axis=-1) == 0
        assert not got[phantom].any()


def test_jitted_reference_within_an_ulp():
    f, nbr, occ, w = _case(7, 6, 8, 32, 16)
    want = np.asarray(jax.jit(lambda *a: jbk.brick_conv_int8(*a, mask_out=False))(
        jnp.asarray(f), jnp.asarray(nbr), jnp.asarray(w), jnp.asarray(occ)))
    got = _torch(f, nbr, w, occ, torch.float32, False)
    np.testing.assert_allclose(got, want, rtol=2.0**-22, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_codes_and_scales_match_sps_tpu(dtype):
    """The codes and scales of sps_tpu/ops/brick.py::brick_conv_int8's
    quantization (its lines, op by op), at f32 and bf16 storage."""
    f, _, _, w = _case(11, 4, 8, 32, 16)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    x = jnp.asarray(f, jdt)
    amax = jnp.max(jnp.abs(x)).astype(jnp.float32)
    s_in = jnp.maximum(amax, 1e-12) * (1.0 / 127.0)
    inv = 1.0 / s_in
    q = jnp.clip(jnp.round(x.astype(jnp.float32) * inv), -127.0, 127.0).astype(jnp.int8)
    wf = jnp.asarray(w)
    s_w = jnp.maximum(jnp.max(jnp.abs(wf), axis=(0, 1, 2, 3)), 1e-12) * (1.0 / 127.0)
    wq = jnp.clip(jnp.round(wf / s_w), -127.0, 127.0).astype(jnp.int8)

    q_t, s_in_t = tbk.quantize_act(torch.from_numpy(f).to(dtype))
    w8, s_w_t = tbk.quantize_weight(torch.from_numpy(w))
    assert q_t.dtype == torch.int8 and s_in_t.dtype == torch.float32 and s_in_t.dim() == 0
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q))
    assert s_in_t.numpy() == np.asarray(s_in)
    np.testing.assert_array_equal(w8.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(s_w_t.numpy(), np.asarray(s_w))
    # The codes lie (3, 3, 3, TCout, TCin) in memory: the kernel's layout.
    assert w8.transpose(-1, -2).is_contiguous()
    assert np.abs(np.asarray(q)).max() == 127


@pytest.mark.parametrize("c,extreme", [(16, False), (32, True)])
def test_int32_sums_equal_a_direct_sum(c, extreme):
    """At |acc| < 2**24 (exact in f32) and scale 1, the plain version's
    output is its int32 sums: they equal a numpy int64 direct sum."""
    rng = np.random.default_rng(c)
    b, n = 2, 16
    if extreme:
        h8 = np.where(rng.random((b, 10, 10, 10, c)) < 0.5, -127, 127).astype(np.int8)
        w8 = np.where(rng.random((3, 3, 3, c, n)) < 0.5, -127, 127).astype(np.int8)
        w8[..., 0] = 127 * np.sign(h8[0, :3, :3, :3])  # column 0 of brick 0's (0,0,0): +max
    else:
        h8 = rng.integers(-127, 128, (b, 10, 10, 10, c)).astype(np.int8)
        w8 = rng.integers(-127, 128, (3, 3, 3, c, n)).astype(np.int8)
    want = np.zeros((b, 8, 8, 8, n), np.int64)
    for kx in range(3):
        for ky in range(3):
            for kz in range(3):
                a = h8[:, kx:kx + 8, ky:ky + 8, kz:kz + 8].astype(np.int64)
                want += a @ w8[kx, ky, kz].astype(np.int64)
    assert np.abs(want).max() < 2**24
    if extreme:
        assert want[0, 0, 0, 0, 0] == 27 * c * 127**2
    got = bi8.brick_conv_int8(torch.from_numpy(h8), torch.from_numpy(w8),
                              torch.ones(n), torch.float32)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))


# The ten int8 calls of one scan on the shipping path (config/config.yaml at
# batch 1): (call, B, TCin, TCout).
PATH_CALLS = [
    ("block8_0.conv1", 11264, 32, 16), ("block8_0.conv2", 11264, 16, 16),
    ("block1_0.conv1", 3072, 16, 16), ("block1_0.conv2", 3072, 16, 16),
    ("block7_0.conv1", 3072, 48, 32), ("block7_0.conv2", 3072, 32, 32),
    ("block2_0.conv1", 1024, 16, 32), ("block2_0.conv2", 1024, 32, 32),
    ("block6_0.conv1", 1024, 96, 64), ("block6_0.conv2", 1024, 64, 64),
]


@pytest.mark.parametrize("call,b,c,n", PATH_CALLS, ids=[c[0] for c in PATH_CALLS])
def test_shape_rule_takes_every_call_of_the_path(call, b, c, n):
    assert bi8.takes((b, 10, 10, 10, c), (3, 3, 3, c, n)), call
    assert bi8.smem_plan(c, n)["smem_bytes"] <= SMEM_LIMIT


@pytest.mark.parametrize("h_shape,w_shape", [
    ((4, 10, 10, 10, 8), (3, 3, 3, 8, 16)),      # C % 16 != 0
    ((4, 10, 10, 10, 24), (3, 3, 3, 24, 16)),    # C % 16 != 0
    ((4, 10, 10, 10, 144), (3, 3, 3, 144, 16)),  # C > 128
    ((4, 10, 10, 10, 32), (3, 3, 3, 32, 8)),     # N not 16, not a multiple of 32
    ((4, 10, 10, 10, 32), (3, 3, 3, 32, 48)),
    ((4, 6, 6, 6, 32), (3, 3, 3, 32, 16)),       # brick side 4
    ((4, 12, 12, 12, 32), (5, 5, 5, 32, 16)),    # k = 5
    ((4, 10, 10, 10, 32), (3, 3, 3, 16, 16)),    # C of h8 and w8 differ
])
def test_shape_rule_refuses(h_shape, w_shape):
    assert not bi8.takes(h_shape, w_shape)


def test_wrapper_refuses_a_device_without_the_kernel():
    """The plain version runs only for CPU tensors and counts no launch;
    elsewhere the wrapper launches the kernel or raises."""
    h8 = torch.zeros((1, 10, 10, 10, 16), dtype=torch.int8)
    w8 = torch.zeros((3, 3, 3, 16, 16), dtype=torch.int8)
    bi8.reset_launches()
    bi8.brick_conv_int8(h8, w8, torch.ones(16), torch.float32)
    assert bi8.LAUNCHES == {"brick_conv_int8": 0}
    with pytest.raises(ValueError):
        bi8.brick_conv_int8(h8.to("meta"), w8.to("meta"), torch.ones(16, device="meta"),
                            torch.float32)


def test_plan_matches_the_kernel_source():
    src = bi8.SOURCE.read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(consts["THREADS"]) == bi8.THREADS
    assert int(consts["C_MAX"]) == bi8.C_MAX
    assert int(consts["PASS_COLS"]) == bi8.PASS_COLS
    assert int(consts["BS"]) + 2 == bi8.H
    assert f"SMEM_BYTES <= {SMEM_LIMIT}" in src
    from sps_torch.ops import zband_conv as zc

    assert bi8.SOURCE in zc.CUDA_SOURCES
    for c in range(16, bi8.C_MAX + 1, 16):
        assert bi8.row_stride(c) // 16 % 2 == 1
        for n in (16, 32, 64, 256):
            plan = bi8.smem_plan(c, n)
            assert plan["smem_bytes"] <= SMEM_LIMIT
            assert plan["passes"] * plan["pass_cols"] == n


def _ldmatrix(buf, addrs, count):
    """ldmatrix .x{count}: matrix m's 8 rows of 16 bytes come from lanes
    8m..8m+7; lane t receives bytes 4(t%4)..4(t%4)+3 of row t/4 of each
    matrix, one 32-bit register per matrix. Returns (32, count, 4) bytes."""
    regs = np.zeros((32, count, 4), np.int64)
    for m in range(count):
        rows = [buf[a : a + 16] for a in addrs[8 * m : 8 * m + 8]]
        for t in range(32):
            regs[t, m] = rows[t // 4][4 * (t % 4) : 4 * (t % 4) + 4]
    return regs


def _a_tile(regs, k32):
    """A (16 x K) from the lanes' registers (PTX mma.m16n8k32 / k16 .s8
    layout): register r holds row g + 8 (r % 2), k 4 tig + 16 (r // 2)."""
    a = np.zeros((16, 32 if k32 else 16), np.int64)
    for t in range(32):
        g, tig = t // 4, t % 4
        for r in range(regs.shape[1]):
            a[g + 8 * (r % 2), 4 * tig + 16 * (r // 2) :][:4] = regs[t, r]
    return a


def _b_tile(regs, k32):
    """B (K x 8): register r holds k 4 tig + 16 r, column g."""
    b = np.zeros((32 if k32 else 16, 8), np.int64)
    for t in range(32):
        g, tig = t // 4, t % 4
        for r in range(2 if k32 else 1):
            b[4 * tig + 16 * r :][:4, g] = regs[t, r]
    return b


@pytest.mark.parametrize("c,n", [(48, 32), (16, 16), (32, 64)])
def test_replayed_copies_and_fragments_compute_the_conv(c, n):
    """One brick through the kernel's copies (into numpy shared memory),
    its ldmatrix addresses and mma operand layouts and its epilogue's
    output map: the int32 sums equal the direct conv."""
    rng = np.random.default_rng(c + n)
    h8 = rng.integers(-127, 128, (10, 10, 10, c)).astype(np.int8)
    w8 = rng.integers(-127, 128, (3, 3, 3, c, n)).astype(np.int8)
    wt = np.ascontiguousarray(w8.transpose(0, 1, 2, 4, 3)).reshape(-1)
    plan = bi8.smem_plan(c, n)
    halo = np.full(plan["halo_bytes"], 999, np.int64)  # 999: not written
    for i in range(1000 * c // 16):
        src, dst = bi8.halo_piece(i, c)
        halo[dst : dst + 16] = h8.reshape(-1)[src : src + 16]
    cols, nt = plan["pass_cols"], plan["pass_cols"] // 8
    steps = [(32 * s, True) for s in range(c // 32)] + ([(c - 16, False)] if c % 32 else [])
    out = np.zeros((8, 8, 8, n), np.int64)
    for n0 in range(0, n, cols):
        acc = np.zeros((8, 4, nt, 16, 8), np.int64)  # warp, m tile, n tile
        for tap in range(27):
            slot = np.full(plan["slot_bytes"], 999, np.int64)
            for i in range(cols * c // 16):
                src, dst = bi8.weight_piece(i, tap, n0, c, n)
                slot[dst : dst + 16] = wt[src : src + 16]
            for c0, k32 in steps:
                count = 4 if k32 else 2
                bt = {}
                for j in range(0, nt, 2):
                    regs = _ldmatrix(slot, [bi8.b_row(t, j, k32, c) + c0 for t in range(32)],
                                     count)
                    per = count // 2  # registers per n tile
                    bt[j] = _b_tile(regs[:, :per], k32)
                    bt[j + 1] = _b_tile(regs[:, per:], k32)
                for warp in range(8):
                    for i in range(4):
                        addrs = [bi8.a_row(warp, t, i, tap, c) + c0 for t in range(32)]
                        a = _a_tile(_ldmatrix(halo, addrs, count), k32)
                        assert (a != 999).all()
                        for j in range(nt):
                            acc[warp, i, j] += a @ bt[j]
        # Epilogue: accumulator e of lane t in tile (i, j) is D[g + 8 (e // 2), 2 tig + e % 2],
        # stored at voxel (warp, 2i + e // 2, g), column n0 + 8j + 2 tig + e % 2.
        for warp in range(8):
            for i in range(4):
                for j in range(nt):
                    for t in range(32):
                        g, tig = t // 4, t % 4
                        for e in range(4):
                            d = acc[warp, i, j, g + 8 * (e // 2), 2 * tig + e % 2]
                            out[warp, 2 * i + e // 2, g, n0 + 8 * j + 2 * tig + e % 2] = d
    want = np.zeros((8, 8, 8, n), np.int64)
    for kx in range(3):
        for ky in range(3):
            for kz in range(3):
                want += (h8[kx:kx + 8, ky:ky + 8, kz:kz + 8].astype(np.int64)
                         @ w8[kx, ky, kz].astype(np.int64))
    np.testing.assert_array_equal(out, want)
