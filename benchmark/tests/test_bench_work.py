"""The work counts on hand-worked sites: kernel-map pairs, the model's
operations and the int8 conv's roofline bound."""

import pytest
import torch

from benchmark import peaks
from benchmark.reference import minkunet as mk
from benchmark.reference import sparse as sp
from benchmark.work import brick_int8
from benchmark.work import minkunet as mk_work


def sites(rows):
    return sp.Sites(torch.tensor(rows, dtype=torch.long))


def test_pairs_of_two_neighbours_in_two_slots():
    # (0,0,0) and (1,0,0) at t = 0 and t = 1: in a 3^4 kernel every site
    # sees all four (both voxels, both slots), so 16 pairs; in the 5^3 x 1
    # stem each sees the two of its own slot, so 8.
    s = sites([[0, 0, 0, 0, 0], [0, 1, 0, 0, 0], [0, 0, 0, 0, 1], [0, 1, 0, 0, 1]])
    assert sp.pairs(sp.neighbors(s, sp.me_offsets(3, 3))) == 16
    assert sp.pairs(sp.neighbors(s, sp.me_offsets(5, 1))) == 8
    # Two voxels 2 apart are not neighbours in a 3^3 kernel, are in a 5^3.
    far = sites([[0, 0, 0, 0, 1], [0, 2, 0, 0, 1]])
    assert sp.pairs(sp.neighbors(far, sp.me_offsets(3, 1))) == 2
    assert sp.pairs(sp.neighbors(far, sp.me_offsets(5, 1))) == 4


def test_operations_of_one_site():
    # One site: every conv pairs it with itself alone at every level, so
    # each conv counts 2 * Cin * Cout once.
    a = mk.Arch()
    pyr = mk.Pyramid(sites([[0, 0, 0, 0, 1]]), a)
    want = 2 * 1 * 8  # stem
    for _, _, _, _, cin, cout, bcin, planes in mk.stages(a):
        want += 2 * cin * cout + 2 * bcin * planes + 2 * planes * planes
        want += 2 * bcin * planes if bcin != planes else 0
    want += 2 * 8 * 1  # head
    assert mk_work.operations(pyr, a) == want


def test_down_pairs_count_the_finer_sites():
    # Eight voxels of one parent: the down conv pairs each with the parent
    # (8 pairs, 1 coarse site), the up conv each with it again.
    rows = [[0, x, y, z, 1] for x in (0, 1) for y in (0, 1) for z in (0, 1)]
    a = mk.Arch()
    pyr = mk.Pyramid(sites(rows), a)
    assert [len(s) for s in pyr.levels] == [8, 1, 1, 1, 1]
    n = [8, 1, 1, 1, 1]
    ops = 2 * 1 * 8 * sp.pairs(pyr.stem)
    for i, (_, _, _, li, cin, cout, bcin, planes) in enumerate(mk.stages(a)):
        ops += 2 * cin * cout * (n[li - 1] if i < 4 else n[li])
        p = sp.pairs(pyr.block[li])
        ops += 2 * bcin * planes * p + 2 * planes * planes * p
        ops += 2 * bcin * planes * n[li] if bcin != planes else 0
    assert sp.pairs(pyr.stem) == 64 and sp.pairs(pyr.block[0]) == 64
    assert mk_work.operations(pyr, a) == ops + 2 * 8 * 8


def test_int8_bound_of_two_bricks():
    # Two sites in two bricks of side 8 at level 0, one brick from level 1
    # up: the block8 convs (32 -> 16, 16 -> 16 packed) run on 2 bricks,
    # blocks 1, 7, 2 and 6 on 1.
    a = mk.Arch()
    pyr = mk.Pyramid(sites([[0, 0, 0, 0, 1], [0, 8, 0, 0, 1]]), a)
    assert [brick_int8.occupied_bricks(pyr, li, 8) for li in range(3)] == [2, 1, 1]
    calls = brick_int8.calls(a, (0, 1, 2), 2)
    assert sorted(calls) == sorted([(1, 16, 16), (1, 16, 16), (2, 16, 32), (2, 32, 32),
                                    (2, 96, 64), (2, 64, 64), (1, 48, 32), (1, 32, 32),
                                    (0, 32, 16), (0, 16, 16)])
    want = 0.0
    for li, ci, co in calls:
        b = 2 if li == 0 else 1
        ops = 2.0 * b * 512 * 27 * ci * co
        nbytes = b * 512 * ci + b * 108 + 27 * ci * co + 4 * co + b * 512 * co * 2
        want += max(ops / peaks.INT8_OPS, nbytes / peaks.HBM_BYTES_PER_S)
    assert brick_int8.bound_s(pyr, a, (0, 1, 2), 8, 2, 2) == pytest.approx(want, rel=1e-12)
