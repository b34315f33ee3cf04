"""The gather engine (voxel rows, hash topology): the port's SPSModel against
sps_tpu's on the same points and weights and against the numpy 4D oracle of
tests/sparse_ref.py, and the port's StreamingFilter on
config/config_small.yaml as shipped (ENGINE gather) against sps_tpu's,
narrowed. f32; scores at rtol 1e-3 / atol 1e-4 against sps_tpu (the same
network, sums in another order), at test_minkunet.py's rtol 2e-3 / atol
2e-4 against the oracle. sps_tpu's side is pinned by
scripts/export_torch_assets.py --only spsmodel,gather_stream
(sps_torch/assets/spsmodel_pin.npz, gather_stream_pin.npz)."""

import dataclasses
import os

import numpy as np
import pytest
import torch
from test_torch_stream import WORLD, _flax_tree, model_record, pinned, pinned_runs, world_args

import sps_torch.config as tcfg_mod
from sps_tpu.models.minkunet import MinkUNetConfig as JUNetConfig
from sps_tpu.models.spsnet import SPSConfig as JSPSConfig
from sps_tpu.structs import Capacities as JCaps
from sps_torch.models import spsnet as tsps
from sps_torch.models.minkunet import MinkUNetConfig as TUNetConfig
from sps_torch.ops import topology as ttopo
from sps_torch.stream.engine import StreamingFilter as TFilter
from sps_torch.structs import Capacities as TCaps
from sps_torch.structs import pad_point_batch as tpad
from tests import sparse_ref as ref
from tests.test_minkunet import ref_forward

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 2
NARROW = dict(in_channels=1, out_channels=1, init_dim=4, planes=(4, 8, 8, 8, 8, 8, 8, 4),
              num_time=T)
CAPS = dict(points=2048, voxels=(1024, 512, 512, 256, 128), bricks=(128, 64, 64, 64, 64))
JCFG = JSPSConfig(voxel_size=0.25, caps=JCaps(**CAPS), unet=JUNetConfig(**NARROW),
                  engine="gather")
TCFG = tsps.SPSConfig(voxel_size=0.25, caps=TCaps(**CAPS), unet=TUNetConfig(**NARROW),
                      engine="gather")


def _points(seed, n=500):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-3, 3, size=(n, 3)).astype(np.float32)
    return xyz, rng.integers(0, 2, size=n), rng.integers(0, T, size=n), \
        rng.uniform(0, 1, size=n).astype(np.float32)


@pytest.fixture(scope="module")
def weights():
    """Seeded weights (random BN statistics) as a state_dict and its flax tree."""
    sd = tsps.init_state_dict(TCFG, seed=0)
    return sd, _flax_tree(sd)


def test_spsmodel_gather_matches_sps_tpu_and_the_oracle(weights):
    sd, tree = weights
    pts = _points(3)
    pin = pinned("spsmodel_pin.npz", "gather", model_record(TCFG, sd, (*pts, CAPS["points"])))
    want, aux_j = pin["scores"], {"overflow": pin["overflow"]}
    model = tsps.SPSModel(TCFG)
    model.load_state_dict(sd, strict=True)
    model.eval()
    pb = tpad(*pts, CAPS["points"], device="cpu")
    with torch.inference_mode():
        levels, p2v, overflow = tsps.build_pyramid(pb, TCFG)
        assert all(isinstance(lv, ttopo.Level) for lv in levels)
        got, aux_t = model(levels=levels, p2v=p2v, t_idx=pb.t, valid=pb.valid)
    assert not bool(overflow.any()) and not bool(np.asarray(aux_j["overflow"]).any())
    got = got.numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-3, atol=1e-4)

    # The numpy 4D oracle on the port's level-0 voxel set.
    grid = levels[0].grid
    occ = grid.occ.numpy()
    d_out = ref_forward(tree, ref.grid_to_dict(grid.coords.numpy(), occ, 0.5 * occ,
                                                  int(grid.num_voxels)), TCFG)
    coords = np.floor(pts[0] / TCFG.voxel_size).astype(np.int64)
    valid = pb.valid.numpy()
    oracle = np.zeros(len(valid))
    for i in np.nonzero(valid)[0]:
        key = (int(pts[1][i]), *coords[i], int(pts[2][i]))
        oracle[i] = 1.0 / (1.0 + np.exp(-d_out[key][0]))
    np.testing.assert_allclose(got, oracle, rtol=2e-3, atol=2e-4)
    assert (got[valid] > 0).all() and (got[~valid] == 0).all()


def _narrow(base):
    class Narrow(base):
        def sps_config(self, batch_size=None):
            s = super().sps_config(batch_size)
            return dataclasses.replace(s, unet=dataclasses.replace(
                s.unet, init_dim=4, planes=(4, 8, 8, 8, 8, 8, 8, 4)))

    return Narrow


def _load(mod):
    cfg = mod.load(os.path.join(_HERE, "config", "config_small.yaml"))
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    return _narrow(type(cfg))(**fields)


STREAM_META = dict(config="config/config_small.yaml",
                   narrow=dict(init_dim=4, planes=(4, 8, 8, 8, 8, 8, 8, 4)),
                   world={**WORLD, "scans_per_seq": 2}, weights_seed=0)


def stream_inputs(root):
    """The configuration, map, filter arguments and weights of the stream test."""
    cfg_t = _load(tcfg_mod)
    mp, argss = world_args(root, STREAM_META["world"], cfg_t.tpu.scan_points)
    return cfg_t, mp, argss, tsps.init_state_dict(cfg_t.sps_config(1),
                                                   seed=STREAM_META["weights_seed"])


def test_streaming_filter_on_config_small_as_shipped(tmp_path):
    """ENGINE gather, no override but the narrowed width: two scans, scores,
    keep away from the threshold and the integer stats equal sps_tpu's;
    the gather engine's stats carry no topology-miss count."""
    cfg_t, mp, argss, sd = stream_inputs(str(tmp_path))
    assert cfg_t.tpu.engine == "gather" and cfg_t.tpu.topo_every == 0
    f_t = TFilter(cfg_t, sd, mp, device="cpu")
    assert f_t.topo_every == 0
    want = pinned_runs("gather_stream_pin.npz", "gather", STREAM_META, mp, argss, sd)
    for args, (s_j, k_j, st_j) in zip(argss, want):
        s_t, k_t, st_t = f_t(*args)
        assert set(st_t) == set(st_j) and "topo_miss_points" not in st_t
        assert not bool(st_t["overflow"])
        s_j = np.asarray(s_j)
        np.testing.assert_allclose(s_t.numpy(), s_j, rtol=1e-3, atol=1e-4)
        far = np.abs(s_j - cfg_t.threshold) > 1e-3
        np.testing.assert_array_equal(k_t.numpy()[far], np.asarray(k_j)[far])
        for name in ("n_scan_voxels", "n_submap_voxels", "n_kept", "overflow"):
            assert int(st_t[name]) == int(st_j[name]), name
        assert 0 < int(st_t["n_submap_voxels"]) < int(st_t["n_scan_voxels"])


def test_the_port_on_the_cpu_matches_the_hash_pin():
    """sps_torch/assets/hash_engines_pin.npz (sps_tpu's gather engine and hash
    join on config_small.yaml as shipped, full width; chip_smoke.py phase
    12a holds the card against it): the port on the CPU gives the first
    scan's voxelize table, point2voxel and join mask bit for bit, and its
    scores within rtol 1e-3 / atol 1e-4."""
    import importlib.util
    import json

    from sps_torch.ops import radius as trad
    from sps_torch.ops import voxelize as tvox

    pin = np.load(os.path.join(_HERE, "sps_torch", "assets", "hash_engines_pin.npz"))
    meta = json.loads(str(pin["meta"]))
    spec = importlib.util.spec_from_file_location(
        "export_torch_assets", os.path.join(_HERE, "scripts", "export_torch_assets.py"))
    exp = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(exp)
    stable, scans, valids, labels = exp.hash_inputs(meta)
    cfg = tcfg_mod.load(os.path.join(_HERE, meta["config"]))
    n = scans.shape[1]
    x, v = torch.as_tensor(scans[0]), torch.as_tensor(valids[0])
    zeros = torch.zeros(n, dtype=torch.int32)
    grid, p2v, _ = tvox.voxelize(tvox.quantize(x, cfg.voxel_size), zeros, zeros + 1, v,
                                 num_time=2, voxel_capacity=cfg.sps_config(1).caps.voxels[0])
    np.testing.assert_array_equal(grid.table.keys.numpy(), pin["voxel/keys"])
    np.testing.assert_array_equal(grid.table.rows.numpy(), pin["voxel/rows"])
    np.testing.assert_array_equal(p2v.numpy(), pin["voxel/p2v"])
    mask, dropped = trad.radius_join(x, v, torch.as_tensor(stable),
                                     torch.ones(len(stable), dtype=torch.bool), cfg.voxel_size,
                                     cell_capacity=cfg.tpu.cell_capacity,
                                     max_per_cell=cfg.tpu.max_per_cell)
    np.testing.assert_array_equal(mask.numpy(), pin["join/mask"])
    assert int(dropped) == int(pin["join/dropped"])
    sd = tsps.init_state_dict(cfg.sps_config(1), seed=meta["weights_seed"])
    filt = TFilter(cfg, sd, stable, device="cpu")
    s, _, st = filt(scans[0], valids[0], labels[0], np.eye(4, dtype=np.float32))
    np.testing.assert_allclose(s.numpy(), pin["scores"][0], rtol=1e-3, atol=1e-4)
    for key in ("n_scan_voxels", "n_submap_voxels", "n_kept"):
        assert int(st[key]) == int(pin[f"stats/{key}"][0]), key
