"""Synthetic LiDAR world and scans (a copy of sps_tpu/data/synthetic.py's
generators, so the port needs nothing of sps_tpu).

The world is a stable environment (ground plane + random boxes, label 0);
clutter boxes present in scans but not in the map are unstable (label 1).
"""

from __future__ import annotations

import numpy as np


def _boxes(rng, n, extent, zmax=2.5):
    """Random axis-aligned box surfaces -> point samples."""
    pts = []
    for _ in range(n):
        cx, cy = rng.uniform(-extent, extent, 2)
        sx, sy = rng.uniform(0.5, 3.0, 2)
        h = rng.uniform(0.8, zmax)
        m = rng.integers(150, 400)
        face = rng.integers(0, 4, m)
        u = rng.uniform(-0.5, 0.5, m)
        z = rng.uniform(0, h, m)
        x = np.where(face < 2, u * sx, np.where(face == 2, -0.5 * sx, 0.5 * sx))
        y = np.where(face >= 2, u * sy, np.where(face == 0, -0.5 * sy, 0.5 * sy))
        pts.append(np.stack([cx + x, cy + y, z], 1))
    return np.concatenate(pts, 0)


def make_world(seed=0, extent=22.0, n_stable=28, ground_points=22000):
    rng = np.random.default_rng(seed)
    g = rng.uniform(-extent, extent, (ground_points, 2))
    ground = np.concatenate([g, np.abs(rng.normal(0, 0.02, (ground_points, 1)))], 1)
    stable = np.concatenate([ground, _boxes(rng, n_stable, extent)], 0)
    return stable.astype(np.float32)


def sample_scan(rng, stable, clutter, pose_xy, n_rays=360 * 3, max_r=25.0):
    """Crude range scan: keep world points within max_r of the sensor,
    subsample, add noise. Returns (pts_world, labels)."""
    world = np.concatenate([stable, clutter], 0)
    labels = np.concatenate([np.zeros(len(stable)), np.ones(len(clutter))]).astype(np.float32)
    d = np.linalg.norm(world[:, :2] - pose_xy[None], axis=1)
    keep = d < max_r
    world, labels = world[keep], labels[keep]
    take = rng.random(len(world)) < min(1.0, n_rays * 14 / max(len(world), 1))
    pts = world[take] + rng.normal(0, 0.015, (take.sum(), 3)).astype(np.float32)
    return pts.astype(np.float32), labels[take]
