"""The gather engine's topology against sps_tpu's on the same points:
voxelize (coords, occupancy, num_voxels, overflow, point2voxel, the pooled
features, the compact table) and build_levels over five levels (nbr[5],
nbr[3], child, parent, parity, each level's grid) bit-equal, with and
without capacity overflow.

sps_tpu's results on these points are pinned by
scripts/export_torch_assets.py --only topology
(sps_torch/assets/topology_pin.npz), which records the points and
capacities they came from."""

import numpy as np
import pytest
import torch
from test_torch_stream import pinned

from sps_torch.data.bench_world import fingerprint
from sps_torch.ops import topology as ttopo
from sps_torch.ops import voxelize as tvox

T = 2
KS = ((5, 3), (3,), (3,), (3,), (3,))


def _points(seed, n=600, span=24):
    """Integer voxel coords of two batches in a cube around the origin
    (negative coordinates included), with duplicates, both time slots and
    ~10% invalid rows."""
    rng = np.random.default_rng(seed)
    base = rng.integers(-span // 2, span // 2, size=(n // 2, 3))
    coords = base[rng.integers(0, len(base), size=n)].astype(np.int32)
    batch = rng.integers(0, 2, size=n).astype(np.int32)
    t = rng.integers(0, T, size=n).astype(np.int32)
    valid = rng.random(n) > 0.1
    feats = rng.standard_normal((n, 3)).astype(np.float32)
    return coords, batch, t, valid, feats


VOXEL_CAPS = {"fits": 512, "overflows": 128}
LEVEL_CAPS = {"fits": (512, 512, 256, 128, 64), "overflows": (512, 128, 32, 16, 8)}
GRID = ("coords", "occ", "num_voxels", "overflow", "table.keys", "table.rows")
LEVEL = ("child", "parent", "parity")


def pin_record(case, seed, caps):
    """What topology_pin.npz records of a case's inputs."""
    return {"case": case, "seed": seed, "caps": caps, "T": T, "kernel_sizes": KS,
            "points": [fingerprint(a) for a in _points(seed)]}


def sps_tpu_voxelize(case):
    """sps_tpu's voxelize of _points(0) at VOXEL_CAPS[case], as pinned."""
    return pinned("topology_pin.npz", f"voxelize/{case}",
                  pin_record(case, 0, VOXEL_CAPS[case]))


def sps_tpu_levels(case):
    """sps_tpu's build_levels of _points(1) at LEVEL_CAPS[case], as pinned."""
    return pinned("topology_pin.npz", f"levels/{case}", pin_record(case, 1, LEVEL_CAPS[case]))


def _eq(got, want, what):
    np.testing.assert_array_equal(got.numpy() if isinstance(got, torch.Tensor) else got,
                                  np.asarray(want), err_msg=what)


def grid_arrays(grid, prefix):
    """A grid's GRID fields under `prefix` (a pin's keys)."""
    return {f"{prefix}{name}": getattr(grid.table, name[6:]) if name.startswith("table.")
            else getattr(grid, name) for name in GRID}


def level_arrays(levels):
    """build_levels' results by key: each level's grid, nbr tables and
    child, parent and parity where the level has them."""
    out = {}
    for li, lv in enumerate(levels):
        out.update(grid_arrays(lv.grid, f"L{li}/"))
        out.update({f"L{li}/nbr{ks}": lv.nbr[ks] for ks in lv.nbr})
        out.update({f"L{li}/{n}": getattr(lv, n) for n in LEVEL if getattr(lv, n) is not None})
    return out


def _check_all(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        _eq(got[key], want[key], key)


@pytest.mark.parametrize("case", VOXEL_CAPS)
def test_voxelize_bit_equal(case):
    cap, pin = VOXEL_CAPS[case], sps_tpu_voxelize(case)
    coords, batch, t, valid, feats = _points(0)
    tg, tp2v, tpooled = tvox.voxelize(*map(torch.as_tensor, (coords, batch, t, valid)),
                                      num_time=T, voxel_capacity=cap,
                                      features=torch.as_tensor(feats))
    _check_all({**grid_arrays(tg, "grid/"), "point2voxel": tp2v, "pooled": tpooled,
                "devoxelize": tvox.devoxelize(tpooled, tp2v, torch.as_tensor(t))}, pin)
    assert bool(tg.overflow) == (cap == 128)


@pytest.mark.parametrize("case", LEVEL_CAPS)
def test_build_levels_bit_equal(case):
    caps, pin = LEVEL_CAPS[case], sps_tpu_levels(case)
    coords, batch, t, valid, _ = _points(1)
    tg, _, _ = tvox.voxelize(*map(torch.as_tensor, (coords, batch, t, valid)), num_time=T,
                             voxel_capacity=caps[0])
    tl = ttopo.build_levels(tg, num_levels=5, capacities=caps, kernel_sizes=KS)
    assert len(tl) == 5
    _check_all(level_arrays(tl), pin)
    overflow = [bool(lv.grid.overflow) for lv in tl]
    assert any(overflow) == (caps[1] == 128)
    assert int((tl[0].nbr[5] >= 0).sum()) > int((tl[0].nbr[3] >= 0).sum()) > 0


def test_chunked_neighbor_table_is_one_lookup(monkeypatch):
    """Chunking the lookups (LOOKUP_QUERIES) does not change a table."""
    coords, batch, t, valid, _ = _points(2)
    tg, _, _ = tvox.voxelize(*map(torch.as_tensor, (coords, batch, t, valid)), num_time=T,
                             voxel_capacity=512)
    whole = ttopo._neighbor_table(tg, ttopo.kernel_offsets(5))
    monkeypatch.setattr(ttopo, "LOOKUP_QUERIES", 512 * 7)
    _eq(ttopo._neighbor_table(tg, ttopo.kernel_offsets(5)), whole, "chunked nbr[5]")
