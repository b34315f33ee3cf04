"""sps_torch.data.bench_world against bench.py::_make_data: the same arrays,
array for array, at a small extent and scan count, with the static protocol
(scans spread around the loop) and the trajectory protocol (traj_step).

bench._make_data keeps a cache at a fixed path in /tmp; here its cache check
is made to miss and its write to do nothing, so it only generates and the
test touches no shared file. bench_world's own cache goes to the test's
temporary directory."""

import dataclasses
import os
import sys
import tempfile

import numpy as np
import pytest

import sps_tpu.config as jcfg_mod
import sps_torch.config as tcfg_mod
from sps_torch.data import bench_world

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
import bench  # noqa: E402

EXTENT = 9.0
N_SCANS = 3
SCAN_POINTS = 4096


class _NoCacheOs:
    """bench's `os`, seeing no cache file."""
    class path:
        @staticmethod
        def exists(p):
            return False


class _NoSaveNp:
    """bench's `np`, writing nothing."""
    def __getattr__(self, name):
        return getattr(np, name)

    @staticmethod
    def savez(*args, **kwargs):
        pass


@pytest.fixture
def isolated(monkeypatch, tmp_path):
    monkeypatch.setattr(bench, "os", _NoCacheOs)
    monkeypatch.setattr(bench, "np", _NoSaveNp())
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return tmp_path


def _bench_make_data(traj_step):
    cfg = jcfg_mod.load(os.path.join(_ROOT, "config", "config.yaml"))
    cfg = dataclasses.replace(cfg, tpu=dataclasses.replace(cfg.tpu, scan_points=SCAN_POINTS))
    return bench._make_data(cfg, N_SCANS, extent=EXTENT, traj_step=traj_step)


@pytest.mark.parametrize("traj_step", [None, 0.2], ids=["static", "trajectory"])
def test_bench_world_equals_bench_make_data(isolated, traj_step):
    want = _bench_make_data(traj_step)
    ns = dataclasses.replace(
        tcfg_mod.load(os.path.join(_ROOT, "config", "config.yaml")).tpu,
        scan_points=SCAN_POINTS).scan_points
    got = bench_world.make_data(ns, N_SCANS, extent=EXTENT, traj_step=traj_step)
    cache = bench_world.cache_path(ns, N_SCANS, EXTENT, traj_step)
    assert os.path.dirname(cache) == str(isolated) and os.path.exists(cache)
    cached = bench_world.make_data(ns, N_SCANS, extent=EXTENT, traj_step=traj_step)
    assert got[1].shape == (N_SCANS, SCAN_POINTS, 3) and got[3].any(1).all()
    for name, g, c, w in zip(("stable", "scans", "labels", "valids"), got, cached, want):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
        np.testing.assert_array_equal(c, w, err_msg=f"{name} (from the cache)")


def test_blt_scale_scans_is_bench_world(isolated):
    """chip_smoke.py's BLT-scale scans are bench_world's trajectory protocol."""
    import chip_smoke

    got = chip_smoke.blt_scale_scans(N_SCANS, SCAN_POINTS, extent=EXTENT)
    want = _bench_make_data(0.2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
