"""The port's measurement tools against sps_tpu's on the same inputs (CPU):

  * sps_torch/scripts/measure_occupancy.py's per-level occupancy against
    scripts/measure_occupancy.py's `occupancy` program, and
    measure_topo_reuse.py's per-scan topology misses against sps_tpu's
    StreamingFilter on the JAX script's loop (scripts/export_torch_assets.py
    holds both sps_tpu programs: jax_occupancy, jax_topo_reuse, and pins
    their results here with --only measure_tools:
    sps_torch/assets/measure_tools_pin.npz), on
    test_torch_shipping.py's world and capacities (config_small.yaml with
    config.yaml's TPU options, MinkUNet14 narrowed; INT8 and bf16 off, which
    change neither the pyramid nor which points it misses). The trajectory
    is the JAX script's, cut to the 12 m world (a 3 m circle, 3 clutter
    boxes, 400 rays, TOPO_EVERY 2, 3 scans a step). Tolerance: a count may
    differ only through points that the two quantizations (the port divides
    by the voxel size on the CPU; XLA under jit multiplies by the
    reciprocal) put in different voxels: quantization_bound's count per scan
    (0 here, so both are exact, as tests/test_torch_stream.py and
    test_torch_shipping.py hold topo_miss_points exactly on their worlds);
  * make_synthetic_data's CLI writes a tree byte-equal to sps_tpu's click
    CLI, run in a subprocess with the same arguments, sparse and --dense.

measure_sp_scaling.py and the collective counter are held in
tests/test_torch_sp_traffic.py.
"""

import dataclasses
import filecmp
import os
import subprocess
import sys

import numpy as np
import pytest
from test_torch_profile_stream import shipping_world
from test_torch_shipping import _load
from test_torch_stream import digest, pinned

import sps_torch.config as tcfg_mod
from sps_torch.data.bench_world import fingerprint
from sps_torch.models import spsnet as tsps
from sps_torch.scripts import make_synthetic_data, measure_occupancy
from sps_torch.scripts import measure_topo_reuse as mtr

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TRAJ = dict(radius=3.0, n_clutter=3, clutter_extent=5.0, n_rays=400, max_r=25.0, seed=1)
STEPS, K, SCANS = (0.2, 1.0, 6.5), 2, 3
META = dict(world="test_torch_profile_stream.shipping_world", world_scans=3, int8=False,
            traj=TRAJ, steps=STEPS, k=K, scans=SCANS, weights_seed=0)


def _cfg(mod):
    cfg = _load(mod)
    return dataclasses.replace(cfg, tpu=dataclasses.replace(cfg.tpu, int8=False))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return shipping_world(str(tmp_path_factory.mktemp("world")), scans=META["world_scans"])


def pin_record(stable, xs, vs, sd):
    """What measure_tools_pin.npz records of its inputs: META and fingerprints
    of the map, the scans' valid points and the weights."""
    return {**META, "map": fingerprint(stable), "weights": digest(sd),
            "scans": [fingerprint(x[v]) for x, v in zip(xs, vs)]}


@pytest.fixture(scope="module")
def pin(world):
    """sps_tpu's occupancy and topology misses on this world, pinned by
    scripts/export_torch_assets.py (export_measure_tools_pin)."""
    sd = tsps.init_state_dict(_cfg(tcfg_mod).sps_config(1), seed=META["weights_seed"])
    return pinned("measure_tools_pin.npz", "measure_tools", pin_record(*world, sd))


def test_occupancy_matches_sps_tpu(world, pin):
    stable, xs, vs = world
    cfg = _cfg(tcfg_mod)
    got = measure_occupancy.occupancy(cfg, stable, xs, vs, device="cpu", log=lambda m: None)
    want = pin["occupancy"]
    # A point that the quantizations put in different voxels moves a level's
    # count by at most one; none of this world's does.
    assert sum(int(mtr.moved(x[v], cfg.voxel_size).sum()) for x, v in zip(xs, vs)) == 0
    assert (got["num"] > 0).all() and not got["overflow"].any()
    np.testing.assert_array_equal(got["cap"], want[0, :, 1])
    np.testing.assert_array_equal(got["num"], want[..., 0])
    np.testing.assert_array_equal(got["overflow"], want[..., 2].astype(bool))
    np.testing.assert_array_equal(got["max"], want[..., 0].max(0))


def test_topo_reuse_misses_match_sps_tpu(world, pin):
    stable = world[0]
    cfg = _cfg(tcfg_mod)
    sd = tsps.init_state_dict(cfg.sps_config(1), seed=META["weights_seed"])
    got = mtr.topo_reuse(cfg, sd, stable, STEPS, K, SCANS, device="cpu", **TRAJ)
    want = {step: list(zip(*(pin[f"topo/{step}/{k}"].tolist()
                             for k in ("miss", "valid", "xyz_sha")))) for step in STEPS}
    for step in STEPS:
        rows = got["rows"][step]
        pts = got["scans_xyz"][step]
        bound = mtr.quantization_bound(pts, K, cfg.voxel_size, cfg.tpu.brick_side)
        assert [r[1] for r in rows] == [w[1] for w in want[step]], step
        assert [fingerprint(p) for p in pts] == [w[2] for w in want[step]], step
        for i, (r, w, b) in enumerate(zip(rows, want[step], bound)):
            assert abs(r[0] - w[0]) <= b, (step, i, r, w, b)
        assert bound == [0] * SCANS
        assert rows[0][0] == 0 and rows[2][0] == 0  # the rebuild scans miss nothing
    assert got["rows"][6.5][1][0] > got["rows"][0.2][1][0] > 0
    entries = {e["step_m"]: e for e in got["trajectories"]}
    assert entries[1.0] == mtr.summary(1.0, K, got["rows"][1.0])
    assert set(entries[1.0]) == {"step_m", "speed_at_10hz_m_s", "reuse_scans",
                                 "miss_points_mean", "miss_points_max", "miss_frac_mean",
                                 "miss_frac_max"}


def test_quantization_bound_counts_moved_points():
    """A point on a voxel face where x / v and x * (1 / v) disagree, its
    brick's points in the next scan, nothing elsewhere."""
    v = np.float32(0.1)
    xs = (np.arange(1, 200000, dtype=np.float32) * np.float32(1e-4))
    moved = xs[np.floor(xs / v) != np.floor(xs * (np.float32(1) / v))]
    assert len(moved) > 0
    p = np.array([[moved[0], 5.0, 5.0]], np.float32)
    far = np.array([[-3.0, -3.0, -3.0]], np.float32)
    rebuild = np.concatenate([p, far])
    reuse = np.concatenate([p + np.float32(0.01), far, far])
    assert mtr.moved(rebuild, 0.1).tolist() == [True, False]
    assert mtr.moved(reuse, 0.1).tolist() == [False, False, False]
    assert mtr.quantization_bound([rebuild, reuse], 2, 0.1, 8) == [0, 1]  # its brick
    assert mtr.quantization_bound([far, rebuild], 2, 0.1, 8) == [0, 1]  # the point itself
    assert mtr.quantization_bound([far, reuse], 2, 0.1, 8) == [0, 0]


CLI_ARGS = {
    "sparse": ["--scans-per-seq", "2", "--seed", "4", "--n-rays", "60", "--ground-points",
               "1500"],
    "dense": ["--dense", "--scans-per-seq", "2", "--seed", "2", "--extent", "4",
              "--n-stable", "4", "--map-density", "40", "--scan-density", "4",
              "--clutter-boxes", "2", "--growth-boxes", "1", "--mover-boxes", "1",
              "--sequences", "a,b", "--clean-sequences", "b"],
}


@pytest.mark.parametrize("mode", sorted(CLI_ARGS))
def test_make_synthetic_data_equals_sps_tpu_cli(mode, tmp_path):
    want, got = tmp_path / "jax", tmp_path / "port"
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, os.path.join(_ROOT, "scripts", "make_synthetic_data.py"),
                        "--root", str(want), *CLI_ARGS[mode]], cwd=_ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    make_synthetic_data.main(["--root", str(got), *CLI_ARGS[mode]])
    files = sorted(os.path.relpath(os.path.join(d, f), want)
                   for d, _, fs in os.walk(want) for f in fs)
    assert len(files) >= 5
    assert files == sorted(os.path.relpath(os.path.join(d, f), got)
                           for d, _, fs in os.walk(got) for f in fs)
    match, mismatch, errors = filecmp.cmpfiles(want, got, files, shallow=False)
    assert not mismatch and not errors and len(match) == len(files)
