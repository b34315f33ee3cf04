"""The gather form's schedule in sps_torch/csrc/brick_conv_int8.cu
(brick_int8_gather_kernel: persistent blocks over the brick list, the
pass's weight resident in shared memory, the next brick's halo copied
while the current one is multiplied), replayed on numpy on the CPU: the
brick-to-block walk, the halo buffers' order of copies, barriers and math,
the shared-memory plans against the kernel source's constants, and the
copies' placements through the kernel's addressing. No JAX.
"""

import re

import numpy as np
import pytest
import torch

from sps_torch.ops import brick as bk
from sps_torch.ops import brick_conv_int8 as bi8

SMS = 132  # the H100's streaming multiprocessors
# chip_smoke.py's INT8_CALLS: (call, C, N) and the plan the kernel takes:
# (columns a pass, passes, halo buffers, shared bytes, blocks an SM by
# shared memory).
PATH_PLANS = [
    ("block8_0.conv1", 32, 16, (16, 1, 1, 68736, 3)),
    ("block8_0.conv2", 16, 16, (16, 1, 2, 38912, 5)),
    ("block1_0", 16, 16, (16, 1, 2, 38912, 5)),
    ("block7_0.conv1", 48, 32, (32, 1, 1, 89472, 2)),
    ("block7_0.conv2", 32, 32, (32, 1, 1, 89472, 2)),
    ("block2_0.conv1", 16, 32, (32, 1, 2, 45824, 4)),
    ("block2_0.conv2", 32, 32, (32, 1, 1, 89472, 2)),
    ("block6_0.conv1", 96, 64, (32, 2, 1, 208768, 1)),
    ("block6_0.conv2", 64, 64, (32, 2, 2, 229120, 1)),
]


def _centres(b, seed):
    """nbr27[13] of an atlas table: the filled slots first, ~10% empty
    slots past them, and a few empty slots among them (a test case only)."""
    rng = np.random.default_rng(seed)
    centre = np.arange(b, dtype=np.int32)
    centre[b - b // 10:] = -1
    centre[rng.random(b) < 0.05] = -1
    return centre


@pytest.mark.parametrize("grid", [SMS * k for k in (1, 2, 3, 4)])
@pytest.mark.parametrize("b", [1, 3, 5, 922, 2765, 10138, 11264])
def test_walk_covers_every_column_once(b, grid):
    """Over all blocks of the grid, every column of nbr27 is multiplied
    (centre row present) or stored as zeros (absent) exactly once, with no
    copy for an empty slot; blocks past the last column do nothing."""
    centre = _centres(b, b + grid)
    seen = np.zeros(b, np.int64)
    for block in range(grid):
        ev = bi8.gather_events(block, grid, centre, bufs=2)
        done = [e[1] for e in ev if e[0] in ("math", "zero")]
        assert done == list(bi8.block_bricks(block, grid, b))
        if block >= b:
            assert ev == []
        for e in ev:
            if e[0] == "math":
                assert centre[e[1]] >= 0
                seen[e[1]] += 1
            elif e[0] == "zero":
                assert centre[e[1]] < 0
                seen[e[1]] += 1
            elif e[0] == "gather":
                assert centre[e[1]] >= 0
    np.testing.assert_array_equal(seen, 1)


@pytest.mark.parametrize("passes", [1, 2])
@pytest.mark.parametrize("bufs", [1, 2])
@pytest.mark.parametrize("b,grid", [(922, 264), (2765, 132), (7, 3), (1, 132)])
def test_buffer_parity_never_overwrites_a_brick_in_use(b, grid, bufs, passes):
    """A halo buffer is refilled only after a barrier that follows the
    math of the brick it held, and a brick's math reads its buffer only
    after its copy was waited on and a barrier followed; every copy is
    consumed by exactly one math, pass by pass, and the weight is copied
    once a pass."""
    centre = _centres(b, 7 * b + bufs)
    for block in range(min(grid, b + 1)):
        ev = bi8.gather_events(block, grid, centre, bufs, passes)
        held = {x: None for x in range(bufs)}      # brick copied in, not yet multiplied
        landed = {x: False for x in range(bufs)}   # its copy waited on, then a barrier
        waited = {x: False for x in range(bufs)}
        free = {x: True for x in range(bufs)}      # no math since the last barrier
        maths = []
        for e in ev:
            if e[0] == "gather":
                _, brick, x = e
                assert free[x] and held[x] is None, (block, e)
                held[x], landed[x], waited[x] = brick, False, False
            elif e[0] == "wait":
                waited = {x: held[x] is not None for x in held}
            elif e[0] == "barrier":
                for x in held:
                    landed[x] = landed[x] or waited[x]
                    free[x] = True
            elif e[0] == "math":
                _, brick, x, p = e
                assert held[x] == brick and landed[x], (block, e)
                held[x], free[x] = None, False
                maths.append((p, brick))
        assert all(v is None for v in held.values())
        mine = [br for br in bi8.block_bricks(block, grid, b) if centre[br] >= 0]
        assert maths == [(p, br) for p in range(passes) for br in mine]
        assert [e[1] for e in ev if e[0] == "weight"] == list(range(passes)) * bool(len(ev))


def _gather_kernel_source():
    src = bi8.SOURCE.read_text()
    start = src.index("brick_int8_gather_kernel(const int8_t*")
    return src[start:src.index("\n}\n", start)]


def test_kernel_source_keeps_the_replayed_order():
    """The kernel's loop holds the steps gather_events replays, in that
    order: wait, barrier, the next brick's copy (two buffers, or an empty
    brick), the taps, with one buffer a barrier before the copy, then the
    stores; no barrier inside the tap loop. The rows of the brick after
    next are loaded before the barrier and stored into the current slot
    right after it, when nothing reads that slot any more."""
    k = _gather_kernel_source()
    order = ["const int row_ahead = ahead ? nbr27[tid * B + bn + G] : 0;",
             "const bool busy = rows[cur][TAPS / 2] >= 0;", "cp_async_wait(true);",
             "__syncthreads();", "if (ahead) rows[cur][tid] = row_ahead;",
             "const bool next = bn < B && rows[cur ^ 1][TAPS / 2] >= 0;",
             "if (next && (plan.bufs == 2 || !busy))", "gather_halo(q8, rows[cur ^ 1]",
             "for (int kxy = 0; kxy < 9; ++kxy)", "if constexpr (plan.bufs == 1) {",
             "__syncthreads();  // every warp is done", "if (next) gather_halo(",
             "store_brick<NT>("]
    loop = k[k.index("for (int it = 0; b < B; b += G, ++it)"):]
    at = [loop.index(s) for s in order]
    assert at == sorted(at)
    taps = loop[loop.index("for (int kxy"):loop.index("if constexpr (plan.bufs == 1) {")]
    assert "__syncthreads" not in taps and "cp_async_wait" not in taps
    assert "if (static_cast<int>(blockIdx.x) >= B) return;" in k


def _consts(src):
    return {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}


@pytest.mark.parametrize("call,c,n,want", PATH_PLANS, ids=[p[0] for p in PATH_PLANS])
def test_plan_of_every_path_call(call, c, n, want):
    plan = bi8.gather_plan(c, n)
    got = (plan["pass_cols"], plan["passes"], plan["bufs"], plan["smem_bytes"],
           bi8.blocks_fit(plan["smem_bytes"]))
    assert got == want, call
    assert plan["smem_bytes"] + bi8.ROWS_BYTES <= 232448
    assert plan["weight_bytes"] == 27 * plan["pass_cols"] * bi8.row_stride(c)


def test_plans_match_the_kernel_source():
    """The mirror's constants and rule are the .cu's: limits, row slots,
    the SM's shared memory; every C the kernel takes has a plan within
    232,448 bytes whose passes cover N."""
    src = bi8.SOURCE.read_text()
    consts = _consts(src)
    assert consts["SMEM_LIMIT"] == bi8.SMEM_LIMIT == 232448
    assert consts["SM_SMEM"] == bi8.SM_SMEM
    assert consts["TAPS"] == 27 and consts["THREADS"] == bi8.THREADS
    assert "constexpr int ROWS_BYTES = 2 * TAPS * 4;" in src and bi8.ROWS_BYTES == 2 * 27 * 4
    assert "GATHER_SMEM_BYTES <= 232448" in src
    for text in ("halo + TAPS * PASS_COLS * s + ROWS_BYTES > SMEM_LIMIT ? 16 : PASS_COLS",
                 "(blocks_fit(two) >= 2 || blocks_fit(two) >= blocks_fit(one))",
                 "return SM_SMEM / (smem + ROWS_BYTES + 1024);",
                 "return {s, halo, cols, weight, bufs, bufs * halo + weight};"):
        assert text in src
    for c in range(16, bi8.C_MAX + 1, 16):
        for n in (16, 32, 64, 96, 256):
            plan = bi8.gather_plan(c, n)
            assert plan["smem_bytes"] + bi8.ROWS_BYTES <= bi8.SMEM_LIMIT, (c, n)
            assert plan["passes"] * plan["pass_cols"] == n and plan["bufs"] in (1, 2)


@pytest.mark.parametrize("c,n", [(16, 16), (32, 16), (48, 32), (64, 64), (96, 64)])
def test_copy_placements_through_the_new_addressing(c, n):
    """Two consecutive bricks' copies into buffers 0 and 1 (gather_piece)
    hold ops/brick.halo's halos at the kernel's row stride, and the
    resident weight's copies (resident_weight_piece) put tap t's column r
    of each pass at (t * cols + r) * S; nothing else is written."""
    rng = np.random.default_rng(c + n)
    b, s = 4, bi8.row_stride(c)
    q8 = rng.integers(-127, 128, (b, 8, 8, 8, c)).astype(np.int8)
    nbr = rng.integers(0, b, (27, b)).astype(np.int32)
    nbr[rng.random((27, b)) < 0.35] = -1
    nbr[13] = np.arange(b)
    want = bk.halo(torch.from_numpy(q8), torch.from_numpy(nbr), 1).numpy()
    flat = q8.reshape(-1)
    halos = np.full(2 * 1000 * s, 999, np.int64)
    for buf, brick in ((0, 1), (1, 2)):
        for i in range(1000 * c // 16):
            src, dst = bi8.gather_piece(i, nbr[:, brick], c, buf)
            halos[dst:dst + 16] = 0 if src is None else flat[src:src + 16]
    placed = halos.reshape(2, 1000, s)
    for buf, brick in ((0, 1), (1, 2)):
        np.testing.assert_array_equal(placed[buf, :, :c], want[brick].reshape(1000, c))
    assert (placed[:, :, c:] == 999).all()

    plan = bi8.gather_plan(c, n)
    cols = plan["pass_cols"]
    wt = rng.integers(-127, 128, (27, n, c)).astype(np.int8)
    for n0 in range(0, n, cols):
        region = np.full(plan["weight_bytes"], 999, np.int64)
        for i in range(27 * cols * c // 16):
            src, dst = bi8.resident_weight_piece(i, n0, c, n)
            region[dst:dst + 16] = wt.reshape(-1)[src:src + 16]
        rows = region.reshape(27, cols, s)
        np.testing.assert_array_equal(rows[:, :, :c], wt[:, n0:n0 + cols])
        assert (rows[:, :, c:] == 999).all()
