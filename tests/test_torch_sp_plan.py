"""The port's spatial slicing (sps_torch/parallel/spatial.py) against
sps_tpu's slice_levels under shard_map on the CPU devices that conftest.py
forces: on a replicated pyramid of tests/test_spatial.py's slab world
(scripts/export_torch_assets.py's sp_points and sp_configs; 968
bricks over the 1024-row L0 capacity, so every block references remote
rows), for 2 and 4 ranks, the aliased pyramid (row_from 3) and the
all-brick one, ghost_frac 0, 7.0 (every remote row fits) and 1e-9 (the
ghost lists floor at 64 rows and overflow), every rank's sliced tables,
remapped [local | ghost] ids, ghost lists and overflow flags bit-equal.
Only slice_levels is compiled; the two pyramids are built once each."""

import os
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from sps_tpu.models import spsnet as jsps
from sps_tpu.parallel import spatial as jsp
from sps_tpu.structs import pad_point_batch as jpad
from sps_torch.models import spsnet as tsps
from sps_torch.parallel import spatial as tsp
from sps_torch.structs import pad_point_batch as tpad

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
import export_torch_assets as exp  # noqa: E402

try:
    from jax.experimental.shard_map import shard_map
except ImportError:  # pragma: no cover
    from jax.shard_map import shard_map

CAPS = exp.SP_CAPS
FORMS = exp.SP_FORMS
FIELDS = ("nbr27", "parent", "oct", "child", "parent_rows", "brick_of_row", "lflat_of_row",
          "parity", "ghost_self", "ghost_child", "ghost_parent")


def _flat(levels, lead):
    """{"L<i>/<field>": array} of a pyramid's tables; lead(x) shapes each."""
    out = {}
    for i, lv in enumerate(levels):
        for f in FIELDS:
            v = getattr(lv, f, None)
            if v is not None:
                out[f"L{i}/{f}"] = lead(v)
        out[f"L{i}/occ"] = lead(lv.grid.occ)
        out[f"L{i}/overflow"] = lead(lv.grid.overflow)
        if hasattr(lv.grid, "coords"):
            out[f"L{i}/coords"] = lead(lv.grid.coords)
    return out


@pytest.fixture(scope="module", params=list(FORMS))
def pyramids(request):
    jcfg, tcfg = exp.sp_configs(FORMS[request.param])
    pts = exp.sp_points()
    jl, _, jov = jax.jit(lambda pb: jsps.build_pyramid(pb, jcfg))(jpad(*pts, CAPS["points"]))
    tl, _, tov = tsps.build_pyramid(tpad(*pts, CAPS["points"], device="cpu"), tcfg)
    assert not bool(np.asarray(jov).any()) and not bool(tov.any())
    return request.param, jl, tl


def _jax_slices(jl, n, frac):
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("sp",))

    def body(levels):
        return _flat(jsp.slice_levels(levels, "sp", ghost_frac=frac), lambda x: x[None])

    fn = shard_map(body, mesh=mesh, in_specs=(P(),), out_specs=P("sp"), check_rep=False)
    return {k: np.asarray(v) for k, v in jax.jit(fn)(jl).items()}


@pytest.mark.parametrize("n,frac", [(2, 0.0), (2, 7.0), (4, 7.0), (4, 1e-9)],
                         ids=["n2-gather", "n2-ghost", "n4-ghost", "n4-ghost-overflow"])
def test_slice_levels_match_sps_tpu(pyramids, n, frac):
    form, jl, tl = pyramids
    want = _jax_slices(jl, n, frac)
    over = []
    for r in range(n):
        got = _flat(tsp.slice_rank(tl, r, n, frac), lambda x: x)
        assert set(got) == set(want), set(got) ^ set(want)
        for k, v in got.items():
            v = v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
            w = want[k][r]
            np.testing.assert_array_equal(v, w.astype(v.dtype), err_msg=f"rank {r} {k}")
        over.append(any(bool(got[f"L{i}/overflow"]) for i in range(len(tl))))
        if frac > 0:
            assert got["L0/ghost_self"].shape[0] == tsp.ghost_capacity(CAPS["bricks"][0], n, frac)
    # 1e-9: 64-row ghost lists cannot hold a slab block's surface.
    assert any(over) == (frac == 1e-9)


def test_ghost_capacity_rounding():
    """sps_tpu's gcap: frac * block rounded up to 64, at least 64, at most
    the other ranks' rows."""
    assert tsp.ghost_capacity(1024, 4, 1e-9) == 64
    assert tsp.ghost_capacity(1024, 4, 0.3) == 128  # 76.8 -> 76 -> 128
    assert tsp.ghost_capacity(1024, 4, 7.0) == 768
    assert tsp.ghost_capacity(1024, 2, 0.5) == 256
    with pytest.raises(ValueError, match="not divisible"):
        tsp._axis_block(1000, 0, 3)
