"""Maximum per-level brick / row occupancy over the benchmark's scans (the
port of scripts/measure_occupancy.py):

    python -m sps_torch.scripts.measure_occupancy [--bricks csv] [--scans 24] [--device cpu]

Runs stages 1 and 2 of the streaming filter's rebuild program
(StreamingFilter.stage_vox: voxelize + map overlap; stage_topo: the
pyramid; no UNet) on every scan of sps_torch.data.bench_world's 24 scans
and prints each level's largest occupancy against its capacity, and the
scans that overflowed a level: the data for sizing TPU.BRICKS, since every
phantom brick above the occupancy pays the full conv cost. Runs on the card
unless --device cpu.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(msg):
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def level_counts(levels) -> list[tuple[int, int, bool]]:
    """(occupied bricks or rows, capacity, overflow) of each level."""
    out = []
    for lv in levels:
        g = lv.grid
        num = g.num_rows if hasattr(g, "num_rows") else g.num_bricks
        out.append((int(num), int(g.occ.shape[0]), bool(g.overflow)))
    return out


def occupancy(cfg, stable, scans, valids, device=None, log=log) -> dict:
    """Stages 1-2 of the atlas engine's rebuild over each scan (identity
    pose; the weights, seeded, are not used). Returns {"num": (S, L)
    occupied bricks or rows, "cap": (L,), "overflow": (S, L), "max": (L,)}."""
    from sps_torch.models import spsnet
    from sps_torch.stream.engine import StreamingFilter

    if cfg.tpu.engine != "atlas":
        raise ValueError("the occupancy sweep runs the atlas engine")
    filt = StreamingFilter(cfg, spsnet.init_state_dict(cfg.sps_config(1), seed=0), stable,
                           device=device)
    dev = filt.device
    pose = torch.eye(4, device=dev)[None]
    rows = []
    with torch.inference_mode():
        for i in range(len(scans)):
            x = torch.as_tensor(scans[i], device=dev)[None]
            v = torch.as_tensor(valids[i], device=dev)[None]
            levels, _ = filt.stage_topo(filt.stage_vox(x, v, pose).grid)
            vals = level_counts(levels)
            rows.append(vals)
            if any(o for _, _, o in vals):
                log(f"  scan {i}: OVERFLOW at levels {[j for j, r in enumerate(vals) if r[2]]}")
    a = np.asarray(rows, dtype=np.int64)
    out = {"num": a[..., 0], "cap": a[0, :, 1], "overflow": a[..., 2].astype(bool),
           "max": a[..., 0].max(0)}
    for li, (m, c) in enumerate(zip(out["max"], out["cap"])):
        log(f"L{li}: max occupancy {m} / cap {c}  ({100.0 * m / c:.0f}%)")
    return out


def main(argv=None):
    from sps_torch import config as cfg_mod
    from sps_torch.data import bench_world
    from sps_torch.structs import resolve_device

    ap = argparse.ArgumentParser(description="Per-level occupancy against the capacities.")
    ap.add_argument("--bricks", default=None, help="csv per-level brick caps (batch budget)")
    ap.add_argument("--scans", type=int, default=24)
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' for the CPU")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    cfg = cfg_mod.load(os.path.join(HERE, "config", "config.yaml"))
    if args.bricks:
        caps = tuple(int(x) for x in args.bricks.split(","))
        cfg = dataclasses.replace(cfg, tpu=dataclasses.replace(cfg.tpu, bricks=caps))
    stable, scans, _, valids = bench_world.make_data(cfg.tpu.scan_points, 24)
    log(f"caps={cfg.sps_config(1).caps.bricks} (sweeping {args.scans} scans)")
    return occupancy(cfg, stable, scans[: args.scans], valids[: args.scans], device=args.device)


if __name__ == "__main__":
    main()
