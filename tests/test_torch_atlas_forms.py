"""The atlas engine's other pyramids against sps_tpu's on the same seeded
coordinates: the all-brick pyramid (row_from None; brick sides 4 and 8)
and the hybrid form (atlas.hybridize_levels: row_from 2 and 3 at side 4),
every table bit-equal (occupancy, nbr27, parent, oct, child, parent_rows,
the row levels' brick / slot decomposition, parity, overflow flags), also
when the brick or row capacities overflow; refresh_occupancy on the
all-brick pyramid bit-equal, and refusing every hybridized pyramid (sps_tpu
asserts where the row level's capacity differs from brick level li - 3's
and, where they coincide, as in "hybrid3", refreshes in the wrong row
order); SPSModel's scores on the hybrid form within rtol 1e-3 / atol 1e-4
of sps_tpu's (f32, the same weights; the all-brick form's are held in
tests/test_torch_spatial.py, which runs sps_tpu on it); and the port's
StreamingFilter on both forms scoring as its SPSModel on the pyramid it
builds (rebuild and, on the all-brick pyramid, reuse)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_model import CAPS, NARROW, _points
from test_torch_stream import _flax_tree

from sps_tpu.models.minkunet import MinkUNetConfig as JUNetConfig
from sps_tpu.models.spsnet import SPSConfig as JSPSConfig
from sps_tpu.models.spsnet import SPSModel as JSPSModel
from sps_tpu.ops import atlas as jatl
from sps_tpu.structs import Capacities as JCaps
from sps_tpu.structs import pad_point_batch as jpad
from sps_torch.models import spsnet as tsps
from sps_torch.models.minkunet import MinkUNetConfig as TUNetConfig
from sps_torch.ops import atlas as tatl
from sps_torch.ops import brick as tbk
from sps_torch.structs import Capacities as TCaps
from sps_torch.structs import pad_point_batch as tpad

T = 2
ROW_CAPS = (4096, 2048, 1024, 1024, 1024)
FITS = (1024, 1024, 1024, 512, 256)
# name: (brick side, row_from, brick caps, row caps, extent)
CASES = {
    "brick4": (4, None, FITS, None, (2, 24, 24, 24)),
    "brick8_overflow": (8, None, (256, 128, 64, 64, 64), None, (2, 12, 12, 12)),
    "hybrid2": (4, 2, FITS, ROW_CAPS, (2, 24, 24, 24)),
    "hybrid3": (4, 3, FITS, ROW_CAPS, (2, 24, 24, 24)),
    "hybrid2_overflow": (4, 2, (256, 128, 64, 64, 64), (512, 256, 128, 64, 32), (2, 24, 24, 24)),
}
FIELDS = ("nbr27", "parent", "oct", "child", "parent_rows", "brick_of_row", "lflat_of_row",
          "parity")


def _coords(seed=0, n=700):
    rng = np.random.default_rng(seed)
    return (rng.integers(-44, 44, (n, 3)).astype(np.int32), rng.integers(0, 2, n).astype(np.int32),
            rng.integers(0, T, n).astype(np.int32), rng.random(n) < 0.9)


def _jax_levels(arrays, bs, row_from, caps, rcaps, extent):
    def f(c, b, t, v):
        grid, _ = jatl.voxelize_bricks(c, b, t, v, num_time=T, brick_capacity=caps[0],
                                       brick_side=bs, extent=extent)
        levels = jatl.build_levels(grid, num_levels=5, capacities=caps)
        return levels if row_from is None else jatl.hybridize_levels(levels, row_from, rcaps)

    return jax.jit(f)(*(jnp.asarray(a) for a in arrays))


def _torch_levels(arrays, bs, row_from, caps, rcaps, extent):
    grid, _ = tatl.voxelize_bricks(*(torch.from_numpy(a) for a in arrays), num_time=T,
                                   brick_capacity=caps[0], brick_side=bs, extent=extent)
    levels = tatl.build_levels(grid, num_levels=5, capacities=caps)
    return levels if row_from is None else tatl.hybridize_levels(levels, row_from, rcaps)


def assert_levels_equal(tl, jl):
    assert len(tl) == len(jl)
    for i, (t, j) in enumerate(zip(tl, jl)):
        assert type(t).__name__ == type(j).__name__, i
        for f in FIELDS:
            if not hasattr(j, f):
                continue
            a, b = getattr(t, f), getattr(j, f)
            assert (a is None) == (b is None), (i, f)
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"L{i} {f}")
        np.testing.assert_array_equal(t.grid.occ.float().numpy(),
                                      np.asarray(j.grid.occ).astype(np.float32), err_msg=f"L{i} occ")
        assert bool(t.grid.overflow) == bool(j.grid.overflow), i
        if isinstance(t, tatl.RowLevel):
            assert int(t.grid.num_rows) == int(j.grid.num_rows), i


@pytest.fixture(scope="module", params=list(CASES))
def built(request):
    case = CASES[request.param]
    arrays = _coords()
    return request.param, case, arrays, _jax_levels(arrays, *case), _torch_levels(arrays, *case)


def test_pyramid_tables_match(built):
    name, (bs, row_from, *_), _, jl, tl = built
    assert_levels_equal(tl, jl)
    kinds = [type(lv) for lv in tl]
    n_brick = 5 if row_from is None else row_from
    assert kinds == [tbk.BrickLevel] * n_brick + [tatl.RowLevel] * (5 - n_brick)
    assert any(bool(lv.grid.overflow) for lv in tl) == name.endswith("overflow")
    if row_from is not None:
        assert tl[row_from - 1].parent_rows.shape[1:] == (bs // 2,) * 3
        assert not any(lv.aliased for lv in tl[row_from:])


def test_refresh_occupancy(built):
    """A new level-0 occupancy through the cached pyramid: the all-brick
    pyramid's levels equal sps_tpu's refresh; a hybridized one is refused
    (sps_tpu's shape assertion; the port checks the alias flag)."""
    name, (bs, row_from, caps, *_), _, jl, tl = built
    rng = np.random.default_rng(5)
    occ0 = (rng.random((caps[0], bs, bs, bs, T)) < 0.3).astype(np.float32)
    occ0 *= np.asarray(jl[0].grid.occ).astype(np.float32).max(axis=(1, 2, 3, 4),
                                                              keepdims=True)
    if row_from is None:
        want = jatl.refresh_occupancy(jl, jnp.asarray(occ0, jnp.bfloat16))
        got = tatl.refresh_occupancy(tl, torch.from_numpy(occ0).to(torch.bfloat16))
        assert_levels_equal(got, want)
        return
    rcaps = CASES[name][3]
    if rcaps[3] != caps[0] or row_from < 3:
        with pytest.raises(AssertionError):
            jatl.refresh_occupancy(jl, jnp.asarray(occ0, jnp.bfloat16))
    with pytest.raises(ValueError, match="hybridized"):
        tatl.refresh_occupancy(tl, torch.from_numpy(occ0).to(torch.bfloat16))


# Model forms: the atlas window of tests/test_torch_model.py's points.
FORMS = {
    "all_brick8": dict(brick_side=8, row_from=None, atlas_extent=(2, 6, 6, 6)),
    "hybrid2_side4": dict(brick_side=4, row_from=2, atlas_extent=(2, 12, 12, 12)),
}
MODEL_CAPS = dict(CAPS, bricks=(512, 256, 128, 128, 128))


def configs(form, conv_mode="halo"):
    kw = dict(voxel_size=0.25, engine="atlas", **FORMS[form])
    jcfg = JSPSConfig(caps=JCaps(**MODEL_CAPS), unet=JUNetConfig(**NARROW, conv_mode=conv_mode),
                      **kw)
    tcfg = tsps.SPSConfig(caps=TCaps(**MODEL_CAPS),
                          unet=TUNetConfig(**NARROW, conv_mode=conv_mode), **kw)
    return jcfg, tcfg


def test_spsmodel_hybrid_matches_sps_tpu():
    jcfg, tcfg = configs("hybrid2_side4")
    sd = tsps.init_state_dict(tcfg, seed=0)
    pts = _points(3)
    want, aux_j = jax.jit(lambda v, b: JSPSModel(jcfg).apply(v, b))(
        jax.tree.map(np.asarray, _flax_tree(sd)), jpad(*pts, CAPS["points"]))
    model = tsps.SPSModel(tcfg)
    model.load_state_dict(sd, strict=True)
    model.eval()
    pb = tpad(*pts, CAPS["points"], device="cpu")
    with torch.inference_mode():
        got, aux_t = model(pb)
    assert not bool(np.asarray(aux_j["overflow"]).any()) and not bool(aux_t["overflow"].any())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-4)
    valid = pb.valid.numpy()
    assert (got.numpy()[valid] > 0).all() and (got.numpy()[~valid] == 0).all()


@pytest.mark.parametrize("form", list(FORMS))
def test_streaming_filter_forms(form):
    """StreamingFilter on both forms: each scan's scores equal SPSModel's on
    the pyramid the filter builds (a rebuild; on the all-brick pyramid with
    TOPO_EVERY 2 the second scan reuses the first's, hybrid pyramids rebuild
    every scan, TOPO_EVERY 0)."""
    from sps_torch.config import Config, DataConfig, TPUConfig
    from sps_torch.stream.engine import StreamingFilter

    f = FORMS[form]
    topo_every = 2 if f["row_from"] is None else 0

    class Narrow(Config):
        def sps_config(self, batch_size=None):
            s = super().sps_config(batch_size)
            return dataclasses.replace(s, unet=dataclasses.replace(s.unet, **NARROW))

    cfg = Narrow(data=DataConfig(root="/tmp"), voxel_size=0.25, tpu=TPUConfig(
        scan_points=1024, submap_points=1024, voxels=MODEL_CAPS["voxels"],
        bricks=MODEL_CAPS["bricks"], engine="atlas", brick_side=f["brick_side"],
        atlas_extent=f["atlas_extent"][1:], conv_mode="halo", row_from=f["row_from"] or 0,
        topo_every=topo_every, int8=False, head_fold=False))
    scfg = cfg.sps_config(1)
    sd = tsps.init_state_dict(scfg, seed=0)
    rng = np.random.default_rng(3)
    mp = rng.uniform(-3, 3, (3000, 3)).astype(np.float32)
    filt = StreamingFilter(cfg, sd, mp, device="cpu")
    model = tsps.SPSModel(scfg)
    model.load_state_dict(sd, strict=True)
    model.eval()
    for i in range(2):
        scan = np.zeros((1024, 3), np.float32)
        scan[:600] = mp[rng.choice(len(mp), 600)] + rng.normal(0, 0.05, (600, 3))
        valid = np.arange(1024) < 600
        scores, keep, stats = filt(scan, valid, np.zeros(1024, np.float32),
                                   np.eye(4, dtype=np.float32))
        assert not bool(stats["overflow"])
        assert int(stats["topo_miss_points"]) == 0
        # The rebuild program's pyramid: the filter's own, scored directly.
        x = torch.from_numpy(scan)
        v = torch.from_numpy(valid)
        _, coords, batch_idx, _ = filt._posed(x[None], v[None], torch.eye(4)[None])
        ones = torch.ones(1024, dtype=torch.int32)
        grid, p2s = tatl.voxelize_bricks(coords, batch_idx, ones, v, num_time=2,
                                         brick_capacity=scfg.caps.bricks[0],
                                         brick_side=scfg.brick_side, extent=scfg.atlas_extent)
        bvalid = torch.arange(scfg.caps.bricks[0]) < grid.num_bricks
        mrow = tatl.atlas_rows(filt.map_grid, torch.where(bvalid, 0, -1), grid.coords[:, 1:])
        mocc = tbk.take_rows(filt.map_grid.occ, mrow)[..., 0]
        occ = torch.stack([grid.occ[..., 1] * mocc, grid.occ[..., 1]], dim=-1)
        with torch.inference_mode():
            levels = tsps.build_levels_from_grid(grid._replace(occ=occ), model.cfg)[0]
            want, _ = model(levels=levels, p2v=p2s, t_idx=ones, valid=v)
        np.testing.assert_allclose(scores.numpy(), want.numpy(), rtol=0, atol=1e-6)
        assert bool((scores[v] > 0).all()) and bool((keep == ((scores <= cfg.threshold) & v)).all())
