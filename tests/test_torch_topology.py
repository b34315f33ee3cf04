"""The gather engine's topology against sps_tpu's on the same points:
voxelize (coords, occupancy, num_voxels, overflow, point2voxel, the pooled
features, the compact table) and build_levels over five levels (nbr[5],
nbr[3], child, parent, parity, each level's grid) bit-equal, with and
without capacity overflow."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sps_tpu.ops import topology as jtopo
from sps_tpu.ops import voxelize as jvox
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


def _eq(got, want, what):
    np.testing.assert_array_equal(got.numpy() if isinstance(got, torch.Tensor) else got,
                                  np.asarray(want), err_msg=what)


def _check_grid(tg, jg, what):
    for name in ("coords", "occ", "num_voxels", "overflow"):
        _eq(getattr(tg, name), getattr(jg, name), f"{what}.{name}")
    _eq(tg.table.keys, jg.table.keys, f"{what}.table.keys")
    _eq(tg.table.rows, jg.table.rows, f"{what}.table.rows")


@pytest.mark.parametrize("cap", [512, 128], ids=["fits", "overflows"])
def test_voxelize_bit_equal(cap):
    coords, batch, t, valid, feats = _points(0)
    f = jax.jit(lambda c, b, tt, v, x: jvox.voxelize(c, b, tt, v, num_time=T,
                                                     voxel_capacity=cap, features=x))
    jg, jp2v, jpooled = f(*map(jnp.asarray, (coords, batch, t, valid, feats)))
    tg, tp2v, tpooled = tvox.voxelize(*map(torch.as_tensor, (coords, batch, t, valid)),
                                      num_time=T, voxel_capacity=cap,
                                      features=torch.as_tensor(feats))
    _check_grid(tg, jg, "grid")
    _eq(tp2v, jp2v, "point2voxel")
    _eq(tpooled, jpooled, "pooled")
    assert bool(tg.overflow) == (cap == 128)
    want = jvox.devoxelize(jpooled, jp2v, jnp.asarray(t))
    _eq(tvox.devoxelize(tpooled, tp2v, torch.as_tensor(t)), want, "devoxelize")


@pytest.mark.parametrize("caps", [(512, 512, 256, 128, 64), (512, 128, 32, 16, 8)],
                         ids=["fits", "overflows"])
def test_build_levels_bit_equal(caps):
    coords, batch, t, valid, _ = _points(1)

    def jrun(c, b, tt, v):
        g, _, _ = jvox.voxelize(c, b, tt, v, num_time=T, voxel_capacity=caps[0])
        return jtopo.build_levels(g, num_levels=5, capacities=caps, kernel_sizes=KS)

    jl = jax.jit(jrun)(*map(jnp.asarray, (coords, batch, t, valid)))
    tg, _, _ = tvox.voxelize(*map(torch.as_tensor, (coords, batch, t, valid)), num_time=T,
                             voxel_capacity=caps[0])
    tl = ttopo.build_levels(tg, num_levels=5, capacities=caps, kernel_sizes=KS)
    assert len(tl) == 5
    for li, (a, b) in enumerate(zip(tl, jl)):
        _check_grid(a.grid, b.grid, f"L{li}")
        assert sorted(a.nbr) == sorted(b.nbr)
        for ks in a.nbr:
            _eq(a.nbr[ks], b.nbr[ks], f"L{li}.nbr[{ks}]")
        for name in ("child", "parent", "parity"):
            x, y = getattr(a, name), getattr(b, name)
            assert (x is None) == (y is None), f"L{li}.{name}"
            if x is not None:
                _eq(x, y, f"L{li}.{name}")
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
