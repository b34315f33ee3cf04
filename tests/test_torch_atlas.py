"""Port of the atlas topology: sps_torch.ops.atlas against sps_tpu.ops.atlas
on the same seeded coordinates (negative ones included). Every table must
be exactly equal: grid coords, atlas, occupancy, neighbour / parent /
octant / child tables, parent_rows and the aliased row levels' occupancy
and tables, also when capacities or the window overflow."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sps_tpu.ops import atlas as jatl
from sps_tpu.ops import brick as jbk
from sps_torch.ops import atlas as tatl
from sps_torch.ops import brick as tbk

T = 2
BS = 8

_jvox = jax.jit(jatl.voxelize_bricks, static_argnames=(
    "num_time", "brick_capacity", "brick_side", "extent"))


_jlevels = jax.jit(
    lambda grid, caps: jatl.alias_row_levels(
        jatl.build_levels(grid, num_levels=3, capacities=caps), 5),
    static_argnums=1,
)


def _eq(got, want, what):
    got = got.float().numpy() if got.dtype == torch.bfloat16 else got.numpy()
    want = np.asarray(want)
    if want.dtype != got.dtype:
        want = want.astype(got.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


# "fits": everything in capacity and window; "overflow": L0 brick capacity
# exceeded and points outside the window (tables must still agree).
CASES = {
    "fits": dict(caps=(768, 512, 128), extent=(2, 12, 12, 12)),
    "overflow": dict(caps=(128, 64, 64), extent=(2, 8, 8, 8)),
}


@pytest.fixture(scope="module", params=list(CASES))
def built(request):
    case = CASES[request.param]
    rng = np.random.default_rng(0)
    n = 700
    coords = rng.integers(-44, 44, (n, 3)).astype(np.int32)
    batch = rng.integers(0, 2, n).astype(np.int32)
    t = rng.integers(0, T, n).astype(np.int32)
    valid = rng.random(n) < 0.9
    kw = dict(num_time=T, brick_capacity=case["caps"][0], brick_side=BS,
              extent=case["extent"])
    jgrid, jp2s = _jvox(jnp.asarray(coords), jnp.asarray(batch), jnp.asarray(t),
                        jnp.asarray(valid), **kw)
    tgrid, tp2s = tatl.voxelize_bricks(torch.from_numpy(coords), torch.from_numpy(batch),
                                       torch.from_numpy(t), torch.from_numpy(valid), **kw)
    jl = _jlevels(jgrid, case["caps"])
    tl = tatl.alias_row_levels(
        tatl.build_levels(tgrid, num_levels=3, capacities=case["caps"]), 5)
    return request.param, (jgrid, jp2s, jl), (tgrid, tp2s, tl)


def test_voxelize_bricks_matches(built):
    name, (jg, jp, _), (tg, tp, _) = built
    for f in ("coords", "occ", "num_bricks", "atlas", "origin", "overflow"):
        _eq(getattr(tg, f), getattr(jg, f), f)
    _eq(tp, jp, "point2slot")
    assert bool(tg.overflow) == (name == "overflow")
    assert tg.occ.dtype == torch.bfloat16


def test_build_levels_and_alias_row_levels_match(built):
    _, (_, _, jl), (_, _, tl) = built
    assert len(tl) == len(jl) == 5
    for li in range(3):
        assert isinstance(tl[li], tbk.BrickLevel) and isinstance(jl[li], jbk.BrickLevel)
        for f in ("coords", "occ", "num_bricks", "atlas", "origin", "overflow"):
            _eq(getattr(tl[li].grid, f), getattr(jl[li].grid, f), f"L{li} {f}")
        for f in ("nbr27", "parent", "oct", "child", "parent_rows"):
            a, b = getattr(tl[li], f), getattr(jl[li], f)
            assert (a is None) == (b is None), f"L{li} {f}"
            if a is not None:
                _eq(a, b, f"L{li} {f}")
    for li in (3, 4):
        assert isinstance(tl[li], tatl.RowLevel)
        for f in ("occ", "num_rows", "overflow"):
            _eq(getattr(tl[li].grid, f), getattr(jl[li].grid, f), f"L{li} row {f}")
        for f in ("nbr27", "brick_of_row", "lflat_of_row", "child", "parent", "parity"):
            a, b = getattr(tl[li], f), getattr(jl[li], f)
            assert (a is None) == (b is None), f"L{li} {f}"
            if a is not None:
                _eq(a, b, f"L{li} {f}")


def test_refresh_occupancy_matches(built):
    _, (_, _, jl), (_, _, tl) = built
    rng = np.random.default_rng(5)
    occ0 = (rng.random(tuple(tl[0].grid.occ.shape)) < 0.3).astype(np.float32)
    jr = jax.jit(jatl.refresh_occupancy)(jl, jnp.asarray(occ0, jnp.bfloat16))
    tr = tatl.refresh_occupancy(tl, torch.from_numpy(occ0).to(torch.bfloat16))
    for li in range(5):
        _eq(tr[li].grid.occ, jr[li].grid.occ, f"L{li} refreshed occ")


@pytest.mark.parametrize("capacity", [64, 1024])
def test_row_compact_matches(capacity):
    """Slot -> row compaction (exact), also when the capacity overflows."""
    occ = (np.random.default_rng(capacity).random(4096) < 0.05).astype(np.float32)
    want = jax.jit(jatl._row_compact, static_argnums=1)(jnp.asarray(occ), capacity)
    got = tatl._row_compact(torch.from_numpy(occ), capacity)
    for name, g, w in zip(("rowmap", "slot_of_row", "num", "overflow"), got, want):
        _eq(g, w, name)
