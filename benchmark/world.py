"""The benchmark's synthetic world and scans, driven by the run's seed.

A frozen copy of the port's generator (sps_torch/data/bench_world.py on
sps_torch/data/synthetic.py's `make_world`, `_boxes` and `sample_scan`),
kept here so that a change to the program cannot move the yardstick. At
seed 0 it returns bench_world.make_data's arrays bit for bit
(benchmark/tests/test_bench_world.py holds it there); any other seed draws
another world and other scans with the same sizes: the same extent, ground
density, number of structures and clutter boxes, rays a scan and range.

The world is a ground plane plus random boxes (stable, label 0); clutter
boxes lie in the scans but not in the map (label 1). Scan i is taken at
angle `step / radius * i` along a loop of radius extent / 2 (the trajectory
protocol: 0.2 m a scan is 2 m/s at 10 Hz) or, with step None, spread evenly
around the whole loop. Nothing is cached on disk.
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


def make_world(seed, extent, n_stable, ground_points):
    rng = np.random.default_rng(seed)
    g = rng.uniform(-extent, extent, (ground_points, 2))
    ground = np.concatenate([g, np.abs(rng.normal(0, 0.02, (ground_points, 1)))], 1)
    stable = np.concatenate([ground, _boxes(rng, n_stable, extent)], 0)
    return stable.astype(np.float32)


class _Near:
    """The world's points bucketed into square columns of side `cell`, so
    that a scan visits only the columns within its range. The selection
    keeps the points' order, so a scan draws the same numbers as one that
    tests every point of the world."""

    def __init__(self, xy: np.ndarray, cell: float):
        self.cell = cell
        self.ij = np.floor(xy / cell).astype(np.int64)
        self.lo = self.ij.min(axis=0)
        span = self.ij.max(axis=0) - self.lo + 1
        self.ny = int(span[1])
        key = (self.ij[:, 0] - self.lo[0]) * self.ny + (self.ij[:, 1] - self.lo[1])
        self.order = np.argsort(key, kind="stable")
        self.starts = np.searchsorted(key[self.order], np.arange(int(span[0]) * self.ny + 1))
        self.span = span

    def candidates(self, center: np.ndarray, r: float) -> np.ndarray:
        """Sorted indices of every point whose column meets the disc."""
        lo = np.maximum(np.floor((center - r) / self.cell).astype(np.int64) - self.lo, 0)
        hi = np.minimum(np.floor((center + r) / self.cell).astype(np.int64) - self.lo,
                        self.span - 1)
        parts = []
        for i in range(int(lo[0]), int(hi[0]) + 1):
            a = self.starts[i * self.ny + int(lo[1])]
            b = self.starts[i * self.ny + int(hi[1]) + 1]
            parts.append(self.order[a:b])
        if not parts:
            return np.zeros(0, np.int64)
        return np.sort(np.concatenate(parts))


def sample_scan(rng, world, labels, near, pose_xy, n_rays, max_r):
    """Crude range scan: keep world points within max_r of the sensor,
    subsample, add noise. Returns (pts_world, labels)."""
    idx = near.candidates(np.asarray(pose_xy, np.float64), max_r)
    d = np.linalg.norm(world[idx, :2] - pose_xy[None], axis=1)
    idx = idx[d < max_r]
    pts, lab = world[idx], labels[idx]
    take = rng.random(len(pts)) < min(1.0, n_rays * 14 / max(len(pts), 1))
    out = pts[take] + rng.normal(0, 0.015, (take.sum(), 3)).astype(np.float32)
    return out.astype(np.float32), lab[take]


def make_data(seed: int, scan_points: int, n_scans: int, extent: float = 50.0,
              traj_step: float | None = None, n_rays: int = 360 * 24, max_r: float = 30.0):
    """(stable map (M, 3), scans (n_scans, ns, 3), labels (n_scans, ns),
    valids (n_scans, ns)), ns = scan_points; scans padded with zeros and
    valid False. Scans are in the map frame (their pose is the identity)."""
    ns = scan_points
    area = (extent / 50.0) ** 2
    rng = np.random.default_rng(seed)
    stable = make_world(seed=seed, extent=extent, n_stable=int(120 * area),
                        ground_points=int(1_200_000 * area))
    clutter = _boxes(rng, int(40 * area), 0.8 * extent).astype(np.float32)
    world = np.concatenate([stable, clutter], 0)
    wlabels = np.concatenate([np.zeros(len(stable)), np.ones(len(clutter))]).astype(np.float32)
    near = _Near(world[:, :2].astype(np.float64), cell=max(max_r / 4.0, 1.0))
    scans = np.zeros((n_scans, ns, 3), np.float32)
    labels = np.zeros((n_scans, ns), np.float32)
    valids = np.zeros((n_scans, ns), bool)
    radius = 0.5 * extent
    for i in range(n_scans):
        ang = (traj_step / radius) * i if traj_step else 2 * np.pi * i / n_scans
        pose_xy = radius * np.array([np.cos(ang), np.sin(ang)])
        pts, lab = sample_scan(rng, world, wlabels, near, pose_xy, n_rays, max_r)
        k = min(len(pts), ns)
        scans[i, :k], labels[i, :k], valids[i, :k] = pts[:k], lab[:k], True
    return stable, scans, labels, valids
