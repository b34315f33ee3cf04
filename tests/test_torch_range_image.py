"""The port's range image (sps_torch/data/range_image.py) against sps_tpu's
(numpy on both sides, no JAX program): `project` and `windows` bit-equal
on seeded scans, including out-of-FOV rows (clipped, last write wins),
duplicate rows (np.unique sorts and drops them), rows labelled -1
(dropped) and negative azimuth indices (they wrap)."""

import numpy as np
import pytest

from sps_torch.data import range_image as tri
from sps_tpu.data import range_image as jri


def _scan(seed, n=6000):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32) * np.array([12, 12, 1.5], np.float32)
    # A tenth far above and below the field of view (clipped to the edge beams).
    k = n // 10
    pts[:k, 2] = rng.choice([-1.0, 1.0], size=k) * rng.uniform(8, 30, k).astype(np.float32)
    labels = rng.integers(0, 2, n).astype(np.float32)
    labels[rng.random(n) < 0.05] = -1
    data = np.column_stack([pts, labels]).astype(np.float32)
    # Duplicate rows, and rows that share a pixel with different labels.
    dup = data[rng.integers(0, n, 300)]
    near = data[rng.integers(0, n, 300)].copy()
    near[:, :3] *= 1.0005
    near[:, 3] = 1 - near[:, 3]
    return np.concatenate([data, dup, near])


@pytest.mark.parametrize("lidar", sorted(tri.LIDAR_PARAMS))
@pytest.mark.parametrize("seed", [0, 1])
def test_project_and_windows_bit_equal(lidar, seed):
    assert tri.LIDAR_PARAMS == jri.LIDAR_PARAMS and tri.NUM_SLICES == jri.NUM_SLICES
    data = _scan(seed)
    got, want = tri.project(data, lidar), jri.project(data, lidar)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    p = tri.LIDAR_PARAMS[lidar]
    assert got.shape == (p["num_beams"], tri.NUM_SLICES, 4)
    # Both halves of the azimuth range are filled: negative indices wrapped.
    occupied = np.abs(got[..., :3]).sum(-1) > 0
    assert occupied[:, :512].any() and occupied[:, 512:].any()
    # The edge beams hold the clipped out-of-FOV rows.
    assert occupied[0].sum() > 0 and occupied[-1].sum() > 0
    (wg, lg), (ww, lw) = tri.windows(got, lidar), jri.windows(want, lidar)
    np.testing.assert_array_equal(wg, ww)
    np.testing.assert_array_equal(lg, lw)
    nw = tri.NUM_SLICES // p["window_size"]
    assert wg.shape == (nw, p["num_beams"] * p["window_size"], 3)
    assert lg.shape == (nw, p["num_beams"] * p["window_size"])


def test_label_minus_one_dropped_and_duplicates_ignored():
    data = _scan(2)
    all_dropped = data.copy()
    all_dropped[:, 3] = -1
    assert (tri.project(all_dropped) == 0).all()
    # A scan and the same scan with every row twice, shuffled, give one image.
    rng = np.random.default_rng(0)
    twice = np.concatenate([data, data])[rng.permutation(2 * len(data))]
    np.testing.assert_array_equal(tri.project(twice), tri.project(data))
    np.testing.assert_array_equal(tri.project(twice), jri.project(twice))
