"""NCLT-scale headroom check (the port of scripts/check_nclt_headroom.py):

    python -m sps_torch.scripts.check_nclt_headroom [--scans 12] [--extent 110] \\
        [--config config/config_nclt.yaml] [--device cpu]

Builds a synthetic world of the BLT bench map's surface density over
--extent (make_world(seed 7, 580 structures, 1.2e6 * (extent / 50)^2 ground
points): ~5.8M map points at 110 m, ~5x the bench map), 120 clutter boxes,
and --scans scans (sample_scan, 360 * 24 rays, 30 m range) on a circle of
radius extent / 2, padded to SCAN_POINTS; the world is cached under
build/. The streaming filter at the config as shipped (config_nclt.yaml:
the atlas engine, ATLAS_EXTENT 288 x 288 x 48, INT8, HEAD_FOLD, bf16,
TOPO_EVERY 8; the YAML's BRICKS 28672 / 8192 / 2560 / 1536 / 1024 are for
batch 2, so the filter at batch 1 runs at 14336 / 4096 / 1280 / 768 / 512)
with seeded weights scores every scan at the identity pose. Prints one
JSON line (map size, the largest scan and submap voxel counts, overflow,
brick capacities) and exits 1 if any scan overflowed a capacity. Runs on
the card unless --device cpu.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BLT_BENCH_MAP_POINTS = 1.23e6
WORLD = dict(seed=7, n_stable=580, ground_per_50m=1_200_000, n_clutter=120, clutter_frac=0.8,
             n_rays=360 * 24, max_r=30.0)


def log(m):
    print(f"[{time.strftime('%H:%M:%S')}] {m}", file=sys.stderr, flush=True)


def world(extent, n_scans, scan_points, cache_dir=os.path.join(HERE, "build"), **over):
    """(map points, scans (n_scans, scan_points, 3), valid masks) of the
    NCLT-scale world (WORLD, with `over` replacing its entries), read from
    or written to an npz under cache_dir (None: no cache)."""
    from sps_torch.data import synthetic

    w = {**WORLD, **over}
    tag = "_".join(f"{k}{w[k]}" for k in sorted(w))
    cache = (None if cache_dir is None else os.path.join(
        cache_dir, f"nclt_world_{extent:g}_{n_scans}_{scan_points}_{tag}.npz"))
    if cache and os.path.exists(cache):
        with np.load(cache) as z:
            return z["stable"], z["scans"], z["valids"]
    log(f"generating {extent:g} m world")
    rng = np.random.default_rng(w["seed"])
    stable = synthetic.make_world(seed=w["seed"], extent=extent, n_stable=w["n_stable"],
                                  ground_points=int(w["ground_per_50m"] * (extent / 50.0) ** 2))
    clutter = synthetic._boxes(rng, w["n_clutter"], extent * w["clutter_frac"]).astype(np.float32)
    scans = np.zeros((n_scans, scan_points, 3), np.float32)
    valids = np.zeros((n_scans, scan_points), bool)
    for i in range(n_scans):
        ang = 2 * np.pi * i / n_scans
        pose_xy = (0.5 * extent) * np.array([np.cos(ang), np.sin(ang)])
        pts, _ = synthetic.sample_scan(rng, stable, clutter, pose_xy, n_rays=w["n_rays"],
                                       max_r=w["max_r"])
        k = min(len(pts), scan_points)
        scans[i, :k], valids[i, :k] = pts[:k], True
    if cache:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = f"{cache}.{os.getpid()}.tmp.npz"
        np.savez(tmp, stable=stable, scans=scans, valids=valids)
        os.replace(tmp, cache)
    return stable, scans, valids


def headroom(cfg, stable, scans, valids, device=None):
    """The streaming filter with seeded weights (spsnet.init_state_dict of
    cfg.sps_config(1), seed 0) over the scans at the identity pose. Returns
    (the JSON summary, per-scan {ms, n_scan_voxels, n_submap_voxels,
    n_kept, topo_miss_points, overflow, score_min, score_max} (scores over
    the valid points), the filter); ms is host time around the scan,
    synchronized on a card."""
    import torch

    from sps_torch.models import spsnet
    from sps_torch.stream.engine import StreamingFilter
    from sps_torch.structs import resolve_device

    dev = resolve_device(device)
    state_dict = spsnet.init_state_dict(cfg.sps_config(1), seed=0)
    log(f"map {len(stable)} points ({len(stable) / BLT_BENCH_MAP_POINTS:.1f}x BLT bench map); "
        "building the resident map")
    filt = StreamingFilter(cfg, state_dict, stable, device=dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    eye = np.eye(4, dtype=np.float32)
    labels = np.zeros(scans.shape[1], np.float32)
    pend = []
    for i in range(len(scans)):
        sync()
        t = time.perf_counter()
        scores, _, stats = filt(scans[i], valids[i], labels, eye)
        sync()
        pend.append(((time.perf_counter() - t) * 1e3, scores, stats))
    per_scan = []
    for i, (ms, scores, stats) in enumerate(pend):
        s = scores.reshape(-1).float()[torch.as_tensor(valids[i], device=scores.device)]
        row = {"ms": ms, **{k: int(stats[k]) for k in ("n_scan_voxels", "n_submap_voxels",
                                                      "n_kept", "topo_miss_points")},
               "overflow": bool(stats["overflow"]), "score_min": float(s.min()),
               "score_max": float(s.max())}
        per_scan.append(row)
        log(f"scan {i}: S={row['n_scan_voxels']} M={row['n_submap_voxels']} "
            f"overflow={row['overflow']}")
    out = {
        "map_points": int(len(stable)),
        "map_vs_blt_bench": round(len(stable) / BLT_BENCH_MAP_POINTS, 2),
        "scans": len(scans),
        "max_scan_voxels": max(r["n_scan_voxels"] for r in per_scan),
        "max_submap_voxels": max(r["n_submap_voxels"] for r in per_scan),
        "overflow": any(r["overflow"] for r in per_scan),
        "bricks_caps": list(cfg.sps_config(1).caps.bricks),
    }
    return out, per_scan, filt


def main(argv=None):
    from sps_torch import config as cfg_mod
    from sps_torch.structs import resolve_device

    ap = argparse.ArgumentParser(description="No capacity overflow at NCLT scale.")
    ap.add_argument("--scans", type=int, default=12)
    ap.add_argument("--extent", type=float, default=110.0)
    ap.add_argument("--config", default=os.path.join(HERE, "config", "config_nclt.yaml"))
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' for the CPU")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    cfg = cfg_mod.load(args.config)
    stable, scans, valids = world(args.extent, args.scans, cfg.tpu.scan_points)
    out, per_scan, filt = headroom(cfg, stable, scans, valids, device=args.device)
    print(json.dumps(out), flush=True)
    if out["overflow"]:
        sys.exit(1)
    return out, per_scan, filt


if __name__ == "__main__":
    main()
