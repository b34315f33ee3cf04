"""The benchmark's synthetic world (counterpart of bench.py::_make_data): a
BLT-scale map and scans, the same rng draws, the same arrays.

At the default extent of 50 m the map holds ~1.2M points; extent 110 gives
the NCLT parking-lot scale (~5x the map). Surface density is constant, so
points scale with the area and structures with (extent / 50)^2.

traj_step: scan i is taken `traj_step` metres further along the loop, the
sensor-rate trajectory protocol (0.2 m = 2 m/s at 10 Hz), under which
streaming topology reuse pays real misses. None: the scans are spread around
the whole loop (the static protocol).

The arrays are cached as one npz in the temporary directory
(tempfile.gettempdir(), so TMPDIR moves it), keyed by the scan width, the
scan count, the extent and the step.
"""

from __future__ import annotations

import hashlib
import os
import tempfile

import numpy as np

from sps_torch.data import synthetic


def fingerprint(points: np.ndarray) -> str:
    """The first 16 hex digits of the sha256 of the points' f32 bytes: equal
    arrays on any machine give equal fingerprints (a float sum does not:
    numpy's pairwise summation changes between versions)."""
    return hashlib.sha256(np.ascontiguousarray(points, np.float32).tobytes()).hexdigest()[:16]


def cache_path(scan_points: int, n_scans: int, extent: float = 50.0,
               traj_step: float | None = None) -> str:
    tag = f"_t{traj_step}" if traj_step else ""
    return os.path.join(tempfile.gettempdir(),
                        f"sps_torch_bench_world_{scan_points}_{n_scans}_{int(extent)}{tag}.npz")


def make_data(scan_points: int, n_scans: int, extent: float = 50.0,
              traj_step: float | None = None):
    """(stable map (M, 3), scans (n_scans, ns, 3), labels (n_scans, ns),
    valids (n_scans, ns)), ns = scan_points (a config's SCAN_POINTS); scans
    padded with zeros and valid False."""
    ns = scan_points
    cache = cache_path(ns, n_scans, extent, traj_step)
    if os.path.exists(cache):
        with np.load(cache) as z:
            return z["stable"], z["scans"], z["labels"], z["valids"]
    area = (extent / 50.0) ** 2
    rng = np.random.default_rng(0)
    stable = synthetic.make_world(seed=0, extent=extent, n_stable=int(120 * area),
                                  ground_points=int(1_200_000 * area))
    clutter = synthetic._boxes(rng, int(40 * area), 0.8 * extent).astype(np.float32)
    scans = np.zeros((n_scans, ns, 3), np.float32)
    labels = np.zeros((n_scans, ns), np.float32)
    valids = np.zeros((n_scans, ns), bool)
    radius = 0.5 * extent
    for i in range(n_scans):
        if traj_step:
            ang = (traj_step / radius) * i
        else:
            ang = 2 * np.pi * i / n_scans
        pose_xy = radius * np.array([np.cos(ang), np.sin(ang)])
        pts, lab = synthetic.sample_scan(rng, stable, clutter, pose_xy, n_rays=360 * 24,
                                         max_r=30.0)
        k = min(len(pts), ns)
        scans[i, :k], labels[i, :k], valids[i, :k] = pts[:k], lab[:k], True
    # Written whole, then renamed: a reader never sees a partial file.
    tmp = f"{cache}.{os.getpid()}.tmp.npz"
    np.savez(tmp, stable=stable, scans=scans, labels=labels, valids=valids)
    os.replace(tmp, cache)
    return stable, scans, labels, valids
