"""config/config_nclt.yaml in the port (sps_torch/scripts/check_nclt_headroom.py)
and every config/*.yaml loaded as sps_tpu loads it.

  * Each of the seven configs: sps_torch.config.load gives every field of
    sps_tpu.config.load (the port's fields are a subset; dtypes by name),
    and sps_config(1) the same capacities.
  * The NCLT headroom check against sps_tpu's, pinned by
    scripts/export_torch_assets.py --only nclt (sps_torch/assets/nclt_pin.npz:
    sps_tpu's StreamingFilter over check_nclt_headroom's world at
    config_nclt.yaml, the world and the capacities cut for the CPU as the
    pin's meta lists: extent 4 m, 2 scans, 4 structures, 2 clutter boxes,
    280 rays, SCAN_POINTS 4096, BRICKS 1024 / 512 / 512 / 512 / 512, VOXELS
    16384 ... 1024; INT8, HEAD_FOLD, bf16, the atlas window and TOPO_EVERY
    as shipped). The port's world generator gives the pinned world bit for
    bit; its filter's per-scan scan and submap voxel counts, topology
    misses and overflow flags equal the pin's within 2 voxels a count (a
    point within an ulp of a voxel face can quantize one voxel over: XLA
    multiplies by the voxel size's reciprocal, the port divides), and none
    overflows. ~35 s: the int8 convs' plain version on the CPU is an f64
    conv."""

import dataclasses
import glob
import json
import os
import sys

import numpy as np
import pytest
import torch

from sps_torch import config as tcfg_mod
from sps_torch.convert import ASSETS
from sps_torch.scripts import check_nclt_headroom as hr
from sps_tpu import config as jcfg_mod

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_ROOT, "scripts"))
import export_torch_assets as exp  # noqa: E402

CONFIGS = sorted(glob.glob(os.path.join(_ROOT, "config", "*.yaml")))
PIN = os.path.join(ASSETS, "nclt_pin.npz")
COUNT_TOL = 2  # voxels, per count and scan


def _norm(v):
    if dataclasses.is_dataclass(v):
        return {f.name: _norm(getattr(v, f.name)) for f in dataclasses.fields(v)}
    if isinstance(v, (tuple, list)):
        return [_norm(x) for x in v]
    if isinstance(v, torch.dtype):
        return str(v).removeprefix("torch.")
    if isinstance(v, type):
        import jax.numpy as jnp

        return jnp.dtype(v).name
    return v


def _shared(mine, theirs):
    assert set(mine) <= set(theirs), set(mine) - set(theirs)
    return {k: _shared(v, theirs[k]) if isinstance(v, dict) else theirs[k]
            for k, v in mine.items()}


def test_seven_configs():
    assert len(CONFIGS) == 7, CONFIGS
    assert {os.path.basename(c) for c in CONFIGS} >= {
        "config_nclt.yaml", "config_loc.yaml", "config_loc_small.yaml", "config.yaml"}


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_config_loads_as_sps_tpu(path, tmp_path):
    mine = tcfg_mod.load(path, data_root=str(tmp_path))
    ref = jcfg_mod.load(path, data_root=str(tmp_path))
    m = _norm(mine)
    assert m == _shared(m, _norm(ref))
    assert _norm(mine.sps_config(1).caps) == _norm(ref.sps_config(1).caps)
    assert mine.sps_config(1).atlas_extent == tuple(ref.sps_config(1).atlas_extent)


@pytest.fixture(scope="module")
def pin():
    with np.load(PIN) as z:
        p = {k: z[k] for k in z.files}
    p["meta"] = json.loads(str(p["meta"]))
    return p


def test_pin_records_this_cut(pin):
    meta = pin["meta"]
    assert meta == exp.NCLT_META
    shipped = tcfg_mod.load(os.path.join(_ROOT, meta["config"]))
    s = meta["shipped"]
    # The cut replaces exactly the listed values of the shipped config.
    assert (shipped.tpu.scan_points, list(shipped.tpu.bricks), list(shipped.tpu.voxels)) == (
        s["scan_points"], s["bricks"], s["voxels"])
    assert (s["extent"], s["scans"]) == (110.0, 12)
    assert (s["n_stable"], s["n_clutter"], s["n_rays"]) == (
        hr.WORLD["n_stable"], hr.WORLD["n_clutter"], hr.WORLD["n_rays"])
    assert (shipped.tpu.engine, shipped.tpu.int8, shipped.tpu.head_fold, shipped.tpu.bf16,
            shipped.tpu.topo_every, tuple(shipped.tpu.atlas_extent)) == (
        "atlas", True, True, True, 8, (288, 288, 48))


def _cut_world(meta, cache_dir=None):
    c = meta["cut"]
    return hr.world(c["extent"], c["scans"], c["scan_points"], cache_dir=cache_dir,
                    n_stable=c["n_stable"], n_clutter=c["n_clutter"], n_rays=c["n_rays"])


def test_world_is_sps_tpus(pin, tmp_path):
    stable, scans, valids = _cut_world(pin["meta"])
    np.testing.assert_array_equal(stable, pin["stable"])
    np.testing.assert_array_equal(scans, pin["scans"])
    np.testing.assert_array_equal(valids, pin["valids"])
    # The cache under the given directory returns the same arrays.
    again = _cut_world(pin["meta"], str(tmp_path))
    cached = _cut_world(pin["meta"], str(tmp_path))
    assert len(os.listdir(tmp_path)) == 1
    for a, b in zip(again, cached):
        np.testing.assert_array_equal(a, b)


def test_headroom_counts_match_sps_tpu(pin):
    cfg = exp.nclt_config(tcfg_mod, pin["meta"])
    out, per_scan, _ = hr.headroom(cfg, pin["stable"], pin["scans"], pin["valids"], device="cpu")
    for k in ("n_scan_voxels", "n_submap_voxels", "topo_miss_points"):
        got = np.asarray([r[k] for r in per_scan])
        np.testing.assert_allclose(got, pin[k], rtol=0, atol=COUNT_TOL, err_msg=k)
    assert (pin["n_submap_voxels"] > 1000).all()
    assert [r["overflow"] for r in per_scan] == pin["overflow"].astype(bool).tolist()
    assert not out["overflow"] and out["scans"] == len(pin["scans"])
    assert out["max_scan_voxels"] == max(r["n_scan_voxels"] for r in per_scan)
    assert out["bricks_caps"] == list(cfg.sps_config(1).caps.bricks)
    assert out["map_points"] == len(pin["stable"])
    assert all(0 < r["score_min"] <= r["score_max"] <= 1 for r in per_scan)
