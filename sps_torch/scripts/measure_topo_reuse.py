"""Topology-reuse misses on sensor-rate trajectories (the port of
scripts/measure_topo_reuse.py):

    python -m sps_torch.scripts.measure_topo_reuse [--steps 0.2,1.0,6.5] [--k 8] \\
        [--scans 24] [--out FILE] [--device cpu]

The streaming filter rebuilds the pyramid every k-th scan and reuses it in
between; a point whose brick the cached pyramid does not cover scores
sigmoid(0) = 0.5 until the next rebuild. On a trajectory sampled at a real
per-scan motion (a sensor at 10 Hz moving v m/s moves v / 10 m a scan) this
counts, for each step, the points a scan misses: the world is
sps_torch.data.bench_world's map, 40 clutter boxes (default_rng(1)) and
scans on a circle of radius 25 m. Writes the JAX script's entries to
exp_results/topo_reuse_torch.json (--out) and prints them as one JSON line.
The configuration is config/config.yaml and the weights are
sps_torch.train.create_state's with seed 0, as the JAX script's. Runs on the
card unless --device cpu.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# The JAX script's trajectory: the circle, the clutter and the sensor.
TRAJECTORY = dict(radius=25.0, n_clutter=40, clutter_extent=40.0, n_rays=360 * 24, max_r=30.0,
                  seed=1)


def trajectory_scans(stable, steps, n_scans, scan_points, radius=25.0, n_clutter=40,
                     clutter_extent=40.0, n_rays=360 * 24, max_r=30.0, seed=1):
    """{step: [(xyz (ns, 3), valid (ns,), labels (ns,)) per scan]}, drawn in the
    JAX script's order: one rng for the clutter and every scan of every
    step in turn, scan i at arc length step * i on the circle."""
    from sps_torch.data import synthetic

    rng = np.random.default_rng(seed)
    clutter = synthetic._boxes(rng, n_clutter, clutter_extent).astype(np.float32)
    out = {}
    for step in steps:
        rows = []
        for i in range(n_scans):
            ang = (step * i) / radius  # arc length -> angle
            pose_xy = radius * np.array([np.cos(ang), np.sin(ang)])
            pts, lab = synthetic.sample_scan(rng, stable, clutter, pose_xy, n_rays=n_rays,
                                             max_r=max_r)
            k = min(len(pts), scan_points)
            sx = np.zeros((scan_points, 3), np.float32)
            sl = np.zeros((scan_points,), np.float32)
            sv = np.zeros((scan_points,), bool)
            sx[:k], sl[:k], sv[:k] = pts[:k], lab[:k], True
            rows.append((sx, sv, sl))
        out[step] = rows
    return out


def summary(step, k, rows) -> dict:
    """The JAX script's entry for one trajectory: rows are (misses, valid
    points) per scan; the rebuild scans (i % k == 0) are left out."""
    reuse = [r for i, r in enumerate(rows) if i % k != 0]
    miss = np.array([r[0] for r in reuse], np.float64)
    tot = np.array([r[1] for r in reuse], np.float64)
    return {
        "step_m": step,
        "speed_at_10hz_m_s": step * 10.0,
        "reuse_scans": len(reuse),
        "miss_points_mean": float(miss.mean()),
        "miss_points_max": int(miss.max()),
        "miss_frac_mean": float((miss / tot).mean()),
        "miss_frac_max": float((miss / tot).max()),
    }


def topo_reuse(cfg, state_dict, stable, steps=(0.2, 1.0, 6.5), k=8, n_scans=24, device=None,
               log=None, **trajectory) -> dict:
    """The filter at TOPO_EVERY k over each step's trajectory (invalidated
    before each): {"k", "scans", "trajectories": the JAX script's entries,
    "rows": {step: [(misses, valid points) per scan]}, "scans_xyz": {step:
    the valid points of each scan}}."""
    from sps_torch.stream.engine import StreamingFilter

    cfg = dataclasses.replace(cfg, tpu=dataclasses.replace(cfg.tpu, topo_every=k))
    filt = StreamingFilter(cfg, state_dict, stable, device=device)
    scans = trajectory_scans(stable, steps, n_scans, cfg.tpu.scan_points,
                             **{**TRAJECTORY, **trajectory})
    eye = np.eye(4, dtype=np.float32)
    out = {"k": k, "scans": n_scans, "trajectories": [], "rows": {}, "scans_xyz": {}}
    for step in steps:
        filt.invalidate()
        rows = []
        for sx, sv, sl in scans[step]:
            _, _, stats = filt(sx, sv, sl, eye)
            rows.append((int(stats["topo_miss_points"]), int(sv.sum())))
        entry = summary(step, k, rows)
        out["trajectories"].append(entry)
        out["rows"][step] = rows
        out["scans_xyz"][step] = [sx[sv] for sx, sv, _ in scans[step]]
        if log:
            log(entry)
    return out


def _keys(coords, shift):
    """One int64 key per brick coordinate (x, y, z >> shift)."""
    b = (coords >> shift).astype(np.int64) + (1 << 20)
    return (b[:, 0] << 42) | (b[:, 1] << 21) | b[:, 2]


def moved(xyz, voxel_size) -> np.ndarray:
    """(n,) bool: the points whose voxel differs between dividing by the
    voxel size and multiplying by its f32 reciprocal (XLA under jit, and
    PyTorch on CUDA); each changes at most one occupied cell a side."""
    v = np.float32(voxel_size)
    return (np.floor(xyz / v) != np.floor(xyz * (np.float32(1.0) / v))).any(1)


def quantization_bound(scans_xyz, k, voxel_size, brick_side) -> list[int]:
    """Per scan, how many miss decisions can differ between a quantization
    that divides by the voxel size and one that multiplies by its f32
    reciprocal (XLA under jit, and PyTorch on CUDA): the scan's points whose
    voxel differs between the two, plus its points in a brick that holds
    such a point of the last rebuild scan (the cached pyramid's bricks can
    differ only there). 0 for the rebuild scans, which miss nothing."""
    v = np.float32(voxel_size)
    inv = np.float32(1.0) / v
    shift = int(brick_side).bit_length() - 1
    out, moved_bricks = [], None
    for i, xyz in enumerate(scans_xyz):
        a = np.floor(xyz / v).astype(np.int64)
        b = np.floor(xyz * inv).astype(np.int64)
        m = (a != b).any(1)
        ka, kb = _keys(a, shift), _keys(b, shift)
        if i % k == 0:
            moved_bricks = np.union1d(ka[m], kb[m])
            out.append(0)
            continue
        near = np.isin(ka, moved_bricks) | np.isin(kb, moved_bricks)
        out.append(int((m | near).sum()))
    return out


def main(argv=None):
    from sps_torch import config as cfg_mod
    from sps_torch import train
    from sps_torch.data import bench_world
    from sps_torch.structs import resolve_device

    ap = argparse.ArgumentParser(description="Topology-reuse misses on trajectories.")
    ap.add_argument("--steps", default="0.2,1.0,6.5",
                    help="per-scan motion in m (0.2 = 2 m/s at 10 Hz; 6.5 = the bench "
                         "trajectory's step)")
    ap.add_argument("--k", type=int, default=8, help="rebuild period")
    ap.add_argument("--scans", type=int, default=24)
    ap.add_argument("--out", default=os.path.join(HERE, "exp_results", "topo_reuse_torch.json"))
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' for the CPU")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    cfg = cfg_mod.load(os.path.join(HERE, "config", "config.yaml"))
    stable = bench_world.make_data(cfg.tpu.scan_points, 24)[0]
    sd = train.create_state(cfg, 0, 1, args.device).model.state_dict()
    res = topo_reuse(cfg, sd, stable, [float(s) for s in args.steps.split(",")], args.k,
                     args.scans, device=args.device,
                     log=lambda e: print(e, file=sys.stderr, flush=True))
    out = {key: res[key] for key in ("k", "scans", "trajectories")}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out))
    return res


if __name__ == "__main__":
    main()
