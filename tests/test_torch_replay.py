"""The port's replay (sps_torch/stream/replay.py) and its prefetcher
(sps_torch/data/prefetch.py), on the CPU.

- The prefetcher yields the same padded (cap, cols) float32 arrays and row
  counts as sps_tpu's native Replayer (csrc/sps_io.cpp): rows and columns
  cut to the capacity, float64 files cast, a 1-D file as one column; a
  corrupt .npy raises IOError at its place in the sequence.
- replay_sequence over a tiny on-disk sequence (narrow widths, f32, topology
  reuse) gives, bit for bit, the scores and keep decisions of a fresh
  StreamingFilter called directly on the same scans in the same order, and
  rows with the same counts and metrics; the kept clouds it writes are the
  kept rows; ReplayStats.summary equals sps_tpu's on the same rows."""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import sps_torch.config as tcfg_mod
from sps_torch.data import blt as tblt
from sps_torch.data import synthetic
from sps_torch.data.prefetch import Replayer
from sps_torch.models import spsnet as tsps
from sps_torch.stream import replay as trep
from sps_torch.stream.engine import StreamingFilter
from sps_tpu import native
from sps_tpu.stream import replay as jrep

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_ROOT, "scripts"))
import export_torch_assets as exp  # noqa: E402

SEQ = "20220629"
WORLD = dict(sequences=(SEQ,), scans_per_seq=3, seed=3, extent=5.0, n_rays=200,
             ground_points=3000, n_stable=6)
TPU = dict(atlas_extent=(20, 20, 8), bricks=(1024, 512, 512, 256, 256), scan_points=4096,
           topo_every=2)


def _files(tmp_path):
    rng = np.random.default_rng(1)
    arrays = [rng.normal(size=(100, 4)).astype(np.float32),
              rng.normal(size=(300, 4)).astype(np.float32),  # more rows than the capacity
              rng.normal(size=(50, 6)),  # float64, more columns
              rng.normal(size=(40, 2)).astype(np.float32),  # fewer columns
              rng.normal(size=(30,)).astype(np.float32)]  # 1-D
    paths = []
    for i, a in enumerate(arrays):
        paths.append(str(tmp_path / f"s{i}.npy"))
        np.save(paths[-1], a)
    return paths


@pytest.mark.parametrize("cap", [200, 60])
def test_prefetcher_matches_native_replayer(tmp_path, cap):
    """Five scans, more than the queue holds: the worker waits for room."""
    paths = _files(tmp_path)
    with Replayer(paths, cap_rows=cap, cols=4) as rep:
        got = list(rep)
    rep_j = native.Replayer(paths, cap_rows=cap, cols=4)
    try:
        want = list(rep_j)
    finally:
        rep_j.close()
    assert len(got) == len(want) == len(paths)
    for (g, gr), (w, wr) in zip(got, want):
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape == (cap, 4)
        assert gr == wr
        np.testing.assert_array_equal(g, w)


def test_prefetcher_raises_on_a_corrupt_scan(tmp_path):
    paths = _files(tmp_path)[:3]
    with open(paths[1], "r+b") as f:
        f.truncate(60)  # header cut short
    with Replayer(paths, cap_rows=200, cols=4) as rep:
        out, rows = next(rep)
        assert rows == 100
        with pytest.raises(IOError, match="s1.npy"):
            next(rep)
        _, rows = next(rep)  # the sequence goes on past the bad scan
        assert rows == 50
        with pytest.raises(StopIteration):
            next(rep)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("replay"))
    synthetic.generate(root, **WORLD)
    cfg = exp.loop_config(tcfg_mod)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, root=root),
                              tpu=dataclasses.replace(cfg.tpu, **TPU))
    return root, cfg, tsps.init_state_dict(cfg.sps_config(1), seed=exp.LOOP_SEED)


def test_replay_equals_the_direct_filter(world, tmp_path):
    root, cfg, sd = world
    lines = []
    out_dir = str(tmp_path / "kept")
    stats = trep.replay_sequence(cfg, sd, SEQ, out_dir=out_dir, log=lines.append, device="cpu")
    paths, poses = tblt.sequence_files(root, SEQ)
    filt = StreamingFilter(cfg, sd, tblt.load_map(root, cfg.data.map_file), device="cpu")
    ns = cfg.tpu.scan_points
    assert len(stats.rows) == len(lines) == len(paths) == WORLD["scans_per_seq"]
    for i, path in enumerate(paths):
        scan = np.load(path)
        n = len(scan)
        sx = np.zeros((ns, 3), np.float32)
        sl = np.zeros(ns, np.float32)
        sv = np.zeros(ns, bool)
        sx[:n], sl[:n], sv[:n] = scan[:, :3], scan[:, 3], True
        scores, keep, m = filt(sx, sv, sl, poses[i])
        assert torch.equal(torch.from_numpy(stats.scores[i]), scores[:n])
        np.testing.assert_array_equal(stats.keeps[i], keep[:n].numpy())
        row = stats.rows[i]
        assert (row["scan"], row["N"]) == (i, n)
        for key, name in (("n_kept", "n_kept"), ("S", "n_scan_voxels"),
                          ("M", "n_submap_voxels")):
            assert row[key] == int(m[name]), key
        for key in ("loss", "r2", "dIoU"):
            assert row[key] == float(m[key]), key
        np.testing.assert_array_equal(np.load(os.path.join(out_dir, f"{i:06d}.npy")),
                                      scan[keep[:n].numpy()])
    assert 0 < stats.rows[0]["n_kept"] < stats.rows[0]["N"]
    summ = stats.summary()
    want = jrep.ReplayStats()
    for row in stats.rows:
        want.add(**row)
    assert summ == want.summary()
    assert summ["scans_per_sec"] > 0 and "dIoU_mean" in summ
