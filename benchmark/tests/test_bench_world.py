"""The benchmark's frozen generator (benchmark/world.py) against the port's
(sps_torch/data/bench_world.py): the same arrays at seed 0, other arrays at
seed 1, and the column buckets that speed up a scan pick the same points
as a test of every point of the world."""

import tempfile

import numpy as np
import pytest

from benchmark import world


@pytest.mark.parametrize("step", [None, 0.2])
def test_seed0_is_the_port_generator(tmp_path, monkeypatch, step):
    from sps_torch.data import bench_world

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    want = bench_world.make_data(4096, 3, extent=9.0, traj_step=step)
    got = world.make_data(0, 4096, 3, extent=9.0, traj_step=step)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_seed1_differs_with_the_same_sizes():
    # The same parameters: scans of the same width, maps within 2% in
    # points (each box draws its own count), other points.
    a = world.make_data(0, 4096, 2, extent=9.0, traj_step=0.2)
    b = world.make_data(1, 4096, 2, extent=9.0, traj_step=0.2)
    assert a[1].shape == b[1].shape
    assert abs(len(a[0]) - len(b[0])) < 0.02 * len(a[0])
    assert not np.array_equal(a[0][:1000], b[0][:1000]) and not np.array_equal(a[1], b[1])


def test_buckets_select_every_point_in_range():
    rng = np.random.default_rng(3)
    xy = rng.uniform(-20, 20, (5000, 2))
    near = world._Near(xy, cell=2.5)
    for center in ([0.0, 0.0], [19.0, -19.5], [-3.3, 7.1]):
        c = np.asarray(center)
        cand = near.candidates(c, 6.0)
        d = np.linalg.norm(xy[cand] - c, axis=1)
        want = np.nonzero(np.linalg.norm(xy - c, axis=1) < 6.0)[0]
        assert np.array_equal(cand[d < 6.0], want)
        assert np.all(np.diff(cand) > 0)
