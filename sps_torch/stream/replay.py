"""Scan replay: a sequence on disk -> the streaming filter at sensor
rate (counterpart of sps_tpu/stream/replay.py).

    python -m sps_torch.stream.replay -w sps_torch/assets/ckpt_loc_movers.npz \\
        -c config/config_loc_movers.yaml -seq 20220629 --data DIR [--rate 10] \\
        [--out-dir DIR] [--device cpu]

Scans stream from disk through the prefetcher (sps_torch/data/prefetch.py:
a worker thread loads scan i+1 while scan i is on the device), arrive in
the sensor frame with the composed map_transform @ pose, and are staged to
the device before the filter call. Each scan is timed from staging to the
end of its device work; its metrics are read back only after the loop.
Logs the reference node's per-scan line (wall time and Hz, loss/r2/dIoU,
point counts N/n/S/M).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from sps_torch.config import Config
from sps_torch.data import blt
from sps_torch.data.prefetch import Replayer
from sps_torch.stream.engine import StreamingFilter
from sps_torch.structs import resolve_device


class ReplayStats:
    """Per-scan rows of a replay, and each scan's scores and keep decisions
    over its rows (numpy)."""

    def __init__(self):
        self.rows = []
        self.scores = []
        self.keeps = []

    def add(self, **kv):
        self.rows.append(kv)

    def summary(self) -> dict:
        if not self.rows:
            return {}
        keys = [k for k, v in self.rows[0].items() if isinstance(v, (int, float))]
        out = {}
        for k in keys:
            vals = np.asarray([r[k] for r in self.rows])
            out[f"{k}_mean"] = float(vals.mean())
            if k == "t_total":
                out["p50_latency_s"] = float(np.percentile(vals, 50))
                out["scans_per_sec"] = float(1.0 / np.percentile(vals, 50))
        return out


def replay_sequence(cfg: Config, state_dict: dict, sequence: str, rate: float = 0.0,
                    out_dir: str | None = None, log=print, device=None) -> ReplayStats:
    """Replay one sequence through the filter.

    rate: target scans a second (0: as fast as possible). out_dir: if set,
    the kept points of each scan are written there as <i>.npy (sensor
    frame, [x, y, z, label])."""
    dev = resolve_device(device)
    paths, poses = blt.sequence_files(cfg.data.root, sequence)
    map_points = blt.load_map(cfg.data.root, cfg.data.map_file)
    filt = StreamingFilter(cfg, state_dict, map_points, device=dev)
    ns = cfg.tpu.scan_points
    stats = ReplayStats()
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    pending = []
    with Replayer(paths, cap_rows=ns, cols=4) as replayer:
        for i, (padded, n) in enumerate(replayer):
            t0 = time.perf_counter()
            x = torch.as_tensor(np.ascontiguousarray(padded[:, :3]), device=dev)
            lab = torch.as_tensor(np.ascontiguousarray(padded[:, 3]), device=dev)
            valid = torch.arange(ns, device=dev) < n
            pose = torch.as_tensor(poses[i], device=dev)
            scores, keep, m = filt(x, valid, lab, pose)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t_total = time.perf_counter() - t0
            pending.append((i, n, t_total, scores, keep, m, padded[:n] if out_dir else None))
            if rate > 0:
                sleep = 1.0 / rate - (time.perf_counter() - t0)
                if sleep > 0:
                    time.sleep(sleep)

    for i, n, t_total, scores, keep, m, scan in pending:
        keep_np = keep.cpu().numpy()[:n]
        stats.scores.append(scores.float().cpu().numpy()[:n])
        stats.keeps.append(keep_np)
        if out_dir:
            np.save(os.path.join(out_dir, f"{i:06d}.npy"), scan[keep_np].astype(np.float32))
        row = dict(scan=i, t_total=t_total, loss=float(m["loss"]), r2=float(m["r2"]),
                   dIoU=float(m["dIoU"]), N=int(n), n_kept=int(m["n_kept"]),
                   S=int(m["n_scan_voxels"]), M=int(m["n_submap_voxels"]))
        stats.add(**row)
        log(f"T: {t_total:.3f} [{1.0 / max(t_total, 1e-9):.2f} Hz] "
            f"L: {row['loss']:.3f} r2: {row['r2']:.3f} dIoU: {row['dIoU']:.3f} "
            f"N: {row['N']} n: {row['n_kept']} S: {row['S']} M: {row['M']}")
    return stats


def main(argv=None):
    from sps_torch import config as cfg_mod
    from sps_torch.convert import load_weights

    ap = argparse.ArgumentParser(description="Replay a sequence through the streaming filter.")
    ap.add_argument("-c", "--config", default="./config/config.yaml")
    ap.add_argument("-w", "--weights", required=True,
                    help="an exported checkpoint .npz, a trainer checkpoint (best.pt) "
                         "or a reference .ckpt")
    ap.add_argument("-seq", "--sequence", required=True)
    ap.add_argument("--data", default=None, help="dataset root (defaults to $DATA)")
    ap.add_argument("--rate", type=float, default=0.0, help="scans a second (0: unpaced)")
    ap.add_argument("--out-dir", default=None, help="write each scan's kept points here")
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' for the CPU")
    args = ap.parse_args(argv)
    cfg = cfg_mod.load(args.config, data_root=args.data)
    sd = load_weights(args.weights, cfg.sps_config(1))
    stats = replay_sequence(cfg, sd, args.sequence, rate=args.rate, out_dir=args.out_dir,
                            device=args.device)
    print(json.dumps(stats.summary(), indent=2))


if __name__ == "__main__":
    main()
