"""The distance-to-map feature (SPSConfig.dist_feature) against sps_tpu
(CPU, f32).

SPSModel at tests/test_torch_model.py's tiny capacities and narrow widths
in halo mode with two input channels; the feature's scatter-min and MAP-slot
zero on the port alone against numpy; StreamingFilter (rebuild, reuse,
rebuild) with the feature on against sps_tpu's on a small world, pinned by
scripts/export_torch_assets.py --only dist_stream (sps_torch/assets/
dist_stream_pin.npz). Scores at rtol 1e-3 / atol 1e-4 (the same network,
sums in another order); the per-point distances within 1e-6 m
(tests/test_torch_register.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_model import CAPS, JCFG, TCFG, _points
from test_torch_stream import (INT_STATS, NARROW, OVERRIDES, WORLD, _flax_tree, _load,
                               pinned_runs, world_args)

import sps_torch.config as tcfg_mod
from sps_tpu.models.spsnet import SPSModel as JSPSModel
from sps_tpu.structs import pad_point_batch as jpad
from sps_torch.models import spsnet as tsps
from sps_torch.stream.engine import StreamingFilter as TFilter
from sps_torch.structs import pad_point_batch as tpad


def _dist_cfg(cfg):
    unet = dataclasses.replace(cfg.unet, in_channels=2, conv_mode="halo")
    return dataclasses.replace(cfg, unet=unet, dist_feature=True, dist_cap=0.8)


def _dists(n, seed):
    """Per-point distances in [0, 1.2): some above the cap."""
    return np.random.default_rng(seed).uniform(0, 1.2, n).astype(np.float32)


def test_spsmodel_dist_feature_matches_sps_tpu():
    tcfg, jcfg = _dist_cfg(TCFG), _dist_cfg(JCFG)
    sd = tsps.init_state_dict(tcfg, seed=2)
    assert sd["MinkUNet.conv0p1s1.kernel"].shape[-2] == 2  # (k^3, kt, Cin, Cout)
    pts = _points(3)
    pdist = np.zeros(CAPS["points"], np.float32)
    pdist[: len(pts[0])] = _dists(len(pts[0]), 4)
    variables = jax.tree.map(np.asarray, _flax_tree(sd))
    want, aux = jax.jit(lambda v, b, d: JSPSModel(jcfg).apply(v, b, point_dist=d))(
        variables, jpad(*pts, CAPS["points"]), jnp.asarray(pdist))
    want = np.asarray(want)
    assert not bool(np.asarray(aux["overflow"]).any())
    model = tsps.SPSModel(tcfg)
    model.load_state_dict(sd, strict=True)
    model.eval()
    pb = tpad(*pts, CAPS["points"], device="cpu")
    with torch.inference_mode():
        levels, p2s, _ = tsps.build_pyramid(pb, tcfg)
        got, _ = model(levels=levels, p2v=p2s, t_idx=pb.t, valid=pb.valid,
                       point_dist=torch.from_numpy(pdist))
        base, _ = model(levels=levels, p2v=p2s, t_idx=pb.t, valid=pb.valid)
    got, valid = got.numpy(), pb.valid.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    assert (got[~valid] == 0).all() and (got[valid] > 0).all()
    assert np.abs(got - base.numpy()).max() > 1e-3  # the distances reach the scores


def test_dist_feats_scatter_min_and_map_slot():
    """The input features against numpy: per (slot, t) cell the least
    distance of its points (dist_cap where it has none), over dist_cap,
    times occupancy; the MAP slot (t = 0) is 0 although its points carry
    distances; channel 0 is 0.5 * occupancy."""
    cfg = _dist_cfg(TCFG)
    model = tsps.SPSModel(cfg)
    t = cfg.unet.num_time
    rng = np.random.default_rng(0)
    occ0 = torch.from_numpy((rng.random((4, 8, 8, 8, t)) < 0.5).astype(np.float32)).bfloat16()
    n = 3000
    p2v = rng.integers(-1, 4 * 512, n).astype(np.int32)
    t_idx = rng.integers(0, t, n).astype(np.int32)
    valid = rng.random(n) < 0.9
    d = _dists(n, 1)
    f = model._dist_feats(occ0, torch.from_numpy(p2v), torch.from_numpy(t_idx),
                          torch.from_numpy(valid), torch.from_numpy(d)).float().numpy()
    cells = np.full(4 * 512 * t, cfg.dist_cap, np.float32)
    for i in np.flatnonzero(valid & (p2v >= 0)):
        c = p2v[i] * t + t_idx[i]
        cells[c] = min(cells[c], d[i])
    occ = occ0.float().numpy()
    want = (cells.reshape(occ.shape) / cfg.dist_cap) * occ
    want[..., tsps.MAP_T] = 0.0
    f = f.reshape(occ.shape + (2,))
    np.testing.assert_array_equal(f[..., 0], 0.5 * occ)
    np.testing.assert_allclose(f[..., 1], want, rtol=1e-6)
    assert (f[..., tsps.MAP_T, 1] == 0).all() and (f[..., 1, 1] > 0).any()


STREAM_META = dict(config="config/config_small.yaml", tpu={**OVERRIDES, "conv_mode": "halo"},
                   narrow=NARROW, dist_feature=True, world=WORLD, weights_seed=0)


def _with_dist(cfg):
    return dataclasses.replace(cfg, dist_feature=True,
                               tpu=dataclasses.replace(cfg.tpu, conv_mode="halo"))


def inputs(root):
    """The configuration, map, filter arguments and weights of the stream runs."""
    cfg_t = _with_dist(_load(tcfg_mod))
    mp, argss = world_args(root, STREAM_META["world"], cfg_t.tpu.scan_points)
    sd = tsps.init_state_dict(cfg_t.sps_config(1), seed=STREAM_META["weights_seed"])
    return cfg_t, mp, argss, sd


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg_t, mp, argss, sd = inputs(str(tmp_path_factory.mktemp("dist")))
    f_t = TFilter(cfg_t, sd, mp, device="cpu")
    assert f_t.map_vm is not None and f_t.map_vm.voxel_size == 4 * cfg_t.voxel_size
    want = pinned_runs("dist_stream_pin.npz", "dist", STREAM_META, mp, argss, sd)
    return cfg_t.threshold, [(f_t(*args), w, args[1]) for args, w in zip(argss, want)]


@pytest.mark.parametrize("i", [0, 1, 2], ids=["rebuild", "reuse", "rebuild2"])
def test_stream_with_dist_feature_matches_sps_tpu(runs, i):
    eps, out = runs
    (s_t, k_t, st_t), (s_j, k_j, st_j), valid = out[i]
    assert not bool(st_t["overflow"]) and not bool(st_j["overflow"])
    s_t, s_j = s_t.numpy(), np.asarray(s_j)
    np.testing.assert_allclose(s_t, s_j, rtol=1e-3, atol=1e-4)
    far = np.abs(s_j - eps) > 1e-3
    np.testing.assert_array_equal(k_t.numpy()[far], np.asarray(k_j)[far])
    for name in INT_STATS:
        assert int(st_t[name]) == int(st_j[name]), name
    assert (s_t[valid] > 0).all() and (s_t[~valid] == 0).all()
