"""Synthetic LiDAR world and scans (a copy of sps_tpu/data/synthetic.py's
generators, so the port needs nothing of sps_tpu; from the same seed they
write the same files bit for bit).

The world is a stable environment (ground plane + random boxes, label 0);
clutter boxes present in scans but not in the map are unstable (label 1).
generate() and generate_dense() write a dataset directory in the BLT layout:

    $DATA/maps/base_map.asc.npy          (M, 4) [x, y, z, label]
    $DATA/sequence/<SEQ>/scans/*.npy     (N, 4) [x, y, z, stability_label], sensor frame
    $DATA/sequence/<SEQ>/poses/*.txt     4x4 comma-delimited pose
    $DATA/sequence/<SEQ>/map_transform   4x4 comma-delimited alignment
"""

from __future__ import annotations

import os

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


def generate(
    root: str,
    sequences=("20220420", "20220601", "20220608", "20220629"),
    scans_per_seq: int = 12,
    seed: int = 0,
    extent: float = 22.0,
    n_rays: int = 360 * 3,
    ground_points: int = 22000,
    n_stable: int = 28,
    step_m: float = 1.0,
):
    """Write a full synthetic dataset. Returns the root path."""
    rng = np.random.default_rng(seed)
    stable = make_world(seed, extent, n_stable=n_stable, ground_points=ground_points)

    os.makedirs(os.path.join(root, "maps"), exist_ok=True)
    map_label = np.zeros((len(stable), 1), np.float32)
    np.save(
        os.path.join(root, "maps", "base_map.asc.npy"),
        np.concatenate([stable, map_label], 1),
    )

    for si, seq in enumerate(sequences):
        srng = np.random.default_rng(seed + 1000 + si)
        clutter = _boxes(srng, 10, extent * 0.8).astype(np.float32)
        sdir = os.path.join(root, "sequence", seq)
        os.makedirs(os.path.join(sdir, "scans"), exist_ok=True)
        os.makedirs(os.path.join(sdir, "poses"), exist_ok=True)
        # Identity map alignment (the reference's map_transform aligns the
        # SLAM frame to the base map; synthetic data is generated in the
        # map frame already but we exercise a nontrivial pose per scan).
        np.savetxt(os.path.join(sdir, "map_transform"), np.eye(4), delimiter=",")
        # Fixed ~step_m arc length between consecutive poses (sensor-rate
        # spacing), NOT a full loop split across scans_per_seq: with few
        # scans the latter yields 10+ m jumps that no constant-velocity
        # prior + ICP can recover from, which is unrepresentative of any
        # real LiDAR stream.
        radius = 0.55 * extent
        ang_step = step_m / radius
        for i in range(scans_per_seq):
            ang = ang_step * i
            pose_xy = radius * np.array([np.cos(ang), np.sin(ang)])
            yaw = ang + np.pi / 2
            c, s = np.cos(yaw), np.sin(yaw)
            pose = np.eye(4)
            pose[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
            pose[:2, 3] = pose_xy
            pts_world, labels = sample_scan(srng, stable, clutter, pose_xy, n_rays=n_rays)
            # Store scan in the sensor frame (pose maps sensor -> world).
            inv = np.linalg.inv(pose)
            pts_sensor = pts_world @ inv[:3, :3].T + inv[:3, 3]
            scan = np.concatenate([pts_sensor, labels[:, None]], 1).astype(np.float32)
            np.save(os.path.join(sdir, "scans", f"{i:06d}.npy"), scan)
            np.savetxt(os.path.join(sdir, "poses", f"{i:06d}.txt"), pose, delimiter=",")
    return root


# Dense world: the map and every scan are independent samples of the same
# surfaces (ground plane + box walls), dense for the map and sensor-like for
# the scans, so scan-vs-map voxel overlap reflects true map support.


def _sample_walls(rng, cx, cy, sx, sy, h, m):
    """m point samples over the 4 wall faces of one axis-aligned box."""
    face = rng.integers(0, 4, m)
    u = rng.uniform(-0.5, 0.5, m)
    z = rng.uniform(0, h, m)
    x = np.where(face < 2, u * sx, np.where(face == 2, -0.5 * sx, 0.5 * sx))
    y = np.where(face >= 2, u * sy, np.where(face == 0, -0.5 * sy, 0.5 * sy))
    return np.stack([cx + x, cy + y, z], 1)


def _box_params(rng, n, extent, zmax=2.5, scale=1.0, ring=None):
    """(n, 5) box parameters [cx, cy, sx, sy, h]. ring=(r0, r1) places
    centers in an annulus around the origin (e.g. near the sensor loop)
    instead of uniformly over the extent."""
    if ring is None:
        cx = rng.uniform(-extent, extent, n)
        cy = rng.uniform(-extent, extent, n)
    else:
        r = rng.uniform(ring[0], ring[1], n)
        a = rng.uniform(0, 2 * np.pi, n)
        cx, cy = r * np.cos(a), r * np.sin(a)
    sx = rng.uniform(0.5, 3.0, n) * scale
    sy = rng.uniform(0.5, 3.0, n) * scale
    h = rng.uniform(0.8, zmax, n)
    return np.stack([cx, cy, sx, sy, h], 1)


def _sample_box_set(rng, params, density, near=None, max_r=None):
    """Sample all boxes' walls at `density` pts/m^2. With (near, max_r),
    skip boxes entirely out of sensor range and drop samples beyond it."""
    pts = []
    for cx, cy, sx, sy, h in params:
        if near is not None:
            dc = np.hypot(cx - near[0], cy - near[1])
            if dc - 0.5 * np.hypot(sx, sy) > max_r:
                continue
        area = 2.0 * (sx + sy) * h
        m = max(4, int(area * density))
        pts.append(_sample_walls(rng, cx, cy, sx, sy, h, m))
    if not pts:
        return np.zeros((0, 3), np.float32)
    p = np.concatenate(pts, 0)
    if near is not None:
        d = np.hypot(p[:, 0] - near[0], p[:, 1] - near[1])
        p = p[d < max_r]
    return p.astype(np.float32)


def _sample_ground(rng, density, extent, near=None, max_r=None):
    """Ground-plane samples at `density` pts/m^2 over the extent square,
    optionally restricted to the sensor disk."""
    if near is None:
        m = int((2 * extent) ** 2 * density)
        g = rng.uniform(-extent, extent, (m, 2))
    else:
        m = int((2 * max_r) ** 2 * density)
        g = rng.uniform(-max_r, max_r, (m, 2)) + np.asarray(near)[None, :]
        g = g[np.hypot(g[:, 0] - near[0], g[:, 1] - near[1]) < max_r]
        g = g[np.all(np.abs(g) < extent, axis=1)]
    z = np.abs(rng.normal(0, 0.02, (len(g), 1)))
    return np.concatenate([g, z], 1).astype(np.float32)


def _growth_params(rng, stable_boxes, n, radius, pad=(0.25, 0.9)):
    """(n, 5) "growth" clutter: inflated copies of stable boxes near the
    sensor loop — walls offset 0.25-0.9 m outside the mapped walls (the
    vegetation-growth / scaffolding change the reference paper targets,
    Readme.md:84-99). These create FALSE point-to-plane correspondences:
    every growth point finds a real wall centroid within the ICP search
    radius with a consistent-sign residual, biasing the pose estimate —
    unlike free-standing clutter, which registration rejects as
    no-correspondence outliers."""
    d = np.abs(np.hypot(stable_boxes[:, 0], stable_boxes[:, 1]) - radius)
    near = np.argsort(d)[: max(4, len(stable_boxes) // 2)]
    idx = near[rng.integers(0, len(near), n)]
    p = stable_boxes[idx].copy()
    p[:, 2] += 2.0 * rng.uniform(*pad, n)  # sx inflated both sides
    p[:, 3] += 2.0 * rng.uniform(*pad, n)
    p[:, 4] *= rng.uniform(0.7, 1.0, n)
    return p


def _mover_params(rng, n, radius):
    """(n, 5) mover boxes (cars/pedestrians: smaller than clutter) plus
    (n, 2) per-scan-step velocities. Movers translate between consecutive
    scans — the inter-scan motion signal a scan-buffer MOS filter (MOS4D)
    needs; static clutter gives it nothing to detect."""
    r = rng.uniform(radius - 5.0, radius + 5.0, n)
    a = rng.uniform(0, 2 * np.pi, n)
    cx, cy = r * np.cos(a), r * np.sin(a)
    sx = rng.uniform(0.4, 2.0, n)
    sy = rng.uniform(0.4, 2.0, n)
    h = rng.uniform(0.5, 1.8, n)
    speed = rng.uniform(0.25, 0.8, n)  # m per scan step
    heading = rng.uniform(0, 2 * np.pi, n)
    vel = np.stack([speed * np.cos(heading), speed * np.sin(heading)], 1)
    return np.stack([cx, cy, sx, sy, h], 1), vel


def generate_dense(
    root: str,
    sequences=("20220420", "20220601", "20220608", "20220629"),
    scans_per_seq: int = 12,
    seed: int = 0,
    extent: float = 22.0,
    n_stable: int = 28,
    map_density: float = 260.0,  # ~2.5 pts per (0.1 m)^2 cell: ~78% stable-point voxel support
    scan_density: float = 28.0,
    clutter_boxes: int = 14,
    clutter_scale: float = 1.6,
    max_r: float = 25.0,
    noise: float = 0.012,
    step_m: float = 1.0,
    growth_boxes: int = 0,
    mover_boxes: int = 0,
    clean_sequences: tuple = (),
):
    """Dense-world synthetic dataset (same on-disk layout as generate()).

    Clutter boxes are placed in an annulus straddling the sensor loop so
    they dominate nearby returns — the regime where an unfiltered scan
    corrupts scan-to-map registration and stability filtering pays off.

    growth_boxes: additional per-sequence clutter as inflated copies of
    mapped structures (walls offset <1 m from real walls) — the change
    mode that biases ICP instead of being outlier-rejected.
    mover_boxes: boxes that TRANSLATE between consecutive scans (0.25-0.8 m
    per step) — actors (cars/pedestrians) whose inter-scan motion is the
    signal scan-buffer MOS filters detect. Labeled unstable (no map
    support), like all clutter.
    clean_sequences: names generated with ZERO clutter (unchanged world) —
    the control where filtering must not hurt.
    """
    rng = np.random.default_rng(seed)
    stable_boxes = _box_params(rng, n_stable, extent)

    map_pts = np.concatenate(
        [
            _sample_ground(rng, map_density, extent),
            _sample_box_set(rng, stable_boxes, map_density),
        ],
        0,
    )
    os.makedirs(os.path.join(root, "maps"), exist_ok=True)
    np.save(
        os.path.join(root, "maps", "base_map.asc.npy"),
        np.concatenate([map_pts, np.zeros((len(map_pts), 1), np.float32)], 1),
    )

    radius = 0.55 * extent
    for si, seq in enumerate(sequences):
        srng = np.random.default_rng(seed + 1000 + si)
        movers_p = np.zeros((0, 5))
        movers_v = np.zeros((0, 2))
        if seq in clean_sequences:
            clutter_boxes_p = np.zeros((0, 5))
        else:
            if mover_boxes:
                movers_p, movers_v = _mover_params(srng, mover_boxes, radius)
            clutter_boxes_p = _box_params(
                srng,
                clutter_boxes,
                extent,
                scale=clutter_scale,
                ring=(radius - 6.0, radius + 6.0),
            )
            if growth_boxes:
                clutter_boxes_p = np.concatenate(
                    [
                        clutter_boxes_p,
                        _growth_params(srng, stable_boxes, growth_boxes, radius),
                    ],
                    0,
                )
        sdir = os.path.join(root, "sequence", seq)
        os.makedirs(os.path.join(sdir, "scans"), exist_ok=True)
        os.makedirs(os.path.join(sdir, "poses"), exist_ok=True)
        np.savetxt(os.path.join(sdir, "map_transform"), np.eye(4), delimiter=",")
        ang_step = step_m / radius
        for i in range(scans_per_seq):
            ang = ang_step * i
            pose_xy = radius * np.array([np.cos(ang), np.sin(ang)])
            yaw = ang + np.pi / 2
            c, s = np.cos(yaw), np.sin(yaw)
            pose = np.eye(4)
            pose[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
            pose[:2, 3] = pose_xy
            sg = _sample_ground(srng, scan_density, extent, pose_xy, max_r)
            sb = _sample_box_set(srng, stable_boxes, scan_density, pose_xy, max_r)
            cb = _sample_box_set(
                srng, clutter_boxes_p, scan_density, pose_xy, max_r
            )
            # Movers: same boxes, per-scan translated centers.
            mp = movers_p.copy()
            if len(mp):
                mp[:, :2] += movers_v * float(i)
            mb = _sample_box_set(srng, mp, scan_density, pose_xy, max_r)
            pts_world = np.concatenate([sg, sb, cb, mb], 0)
            labels = np.concatenate(
                [np.zeros(len(sg) + len(sb)), np.ones(len(cb) + len(mb))]
            ).astype(np.float32)
            pts_world = pts_world + srng.normal(0, noise, pts_world.shape).astype(
                np.float32
            )
            inv = np.linalg.inv(pose)
            pts_sensor = pts_world @ inv[:3, :3].T + inv[:3, 3]
            scan = np.concatenate(
                [pts_sensor, labels[:, None]], 1
            ).astype(np.float32)
            np.save(os.path.join(sdir, "scans", f"{i:06d}.npy"), scan)
            np.savetxt(
                os.path.join(sdir, "poses", f"{i:06d}.txt"), pose, delimiter=","
            )
    return root


# The movers dataset of config/config_loc_movers.yaml's header (the data the
# round-5 checkpoints ckpt_loc_movers*/ were trained on), as generate_dense
# arguments; scans_per_seq there is 60, and scan i of a sequence does not
# depend on scans_per_seq.
MOVERS = dict(sequences=("20220420", "20220601", "20220608", "20220629", "20220629_clean"),
              seed=0, extent=12.0, n_stable=14, map_density=140.0,
              scan_density=9.0, clutter_boxes=10, growth_boxes=4, mover_boxes=3,
              clean_sequences=("20220629_clean",))

# The world of the int8 parity gate (tests/test_int8_parity.py): the movers
# recipe's generator settings with 20220608 generated alone, so its seed is
# seed + 1000 + 0 and its scans differ from MOVERS's 20220608 (index 2).
PARITY = dict(sequences=("20220608",), scans_per_seq=6, seed=0, extent=12.0, n_stable=14,
              map_density=140.0, scan_density=9.0, clutter_boxes=10, growth_boxes=4,
              mover_boxes=3)
