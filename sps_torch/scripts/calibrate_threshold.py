"""Calibrate the filter threshold epsilon on the validation split (the port
of scripts/calibrate_threshold.py):

    python -m sps_torch.scripts.calibrate_threshold -c config/config_loc.yaml \\
        -w WEIGHTS --data DIR [-seq SEQ] [--max-scans 12] [--device cpu]

The streaming filter scores up to --max-scans scans of the sequence
(default: the config's first VAL sequence), spread evenly over it; epsilon
sweeps EPSILON_GRID, a point is called unstable when its score is above
epsilon, and the epsilon of the largest F1 on the unstable class wins.
F1 is 2PR / max(P + R, 1e-9), as the JAX script computes it (not
utils.metrics.classification_metrics, whose denominator is clamped to 1).
Prints one JSON line: epsilon, f1, precision, recall, the curve at every
tenth, the sequence, the point count, the unstable share and the mean
score of each class. WEIGHTS: an .npz export, a trainer's .pt or a
reference .ckpt. Runs on the card unless --device cpu.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

EPSILON_GRID = np.concatenate([np.linspace(0.02, 0.98, 97), np.linspace(0.982, 0.998, 9)])


def sweep_epsilon(scores: np.ndarray, unstable: np.ndarray, **head) -> dict:
    """Max-F1 epsilon over EPSILON_GRID for per-point scores against the
    boolean unstable labels: the best row {epsilon, f1, precision, recall}
    (values rounded as the JAX script rounds them; the first of equal
    F1s), its `curve` (the rows at every tenth), `head` (e.g. the
    sequence) and the counts, in the JAX script's key order."""
    s = np.asarray(scores)
    lbl = np.asarray(unstable, bool)
    best, curve = None, []
    for eps in EPSILON_GRID:
        pred = s > eps
        tp = int((pred & lbl).sum())
        fp = int((pred & ~lbl).sum())
        fn = int((~pred & lbl).sum())
        p = tp / max(tp + fp, 1)
        r = tp / max(tp + fn, 1)
        f1 = 2 * p * r / max(p + r, 1e-9)
        row = {"epsilon": round(float(eps), 3), "f1": round(f1, 4),
               "precision": round(p, 4), "recall": round(r, 4)}
        if abs(eps * 10 - round(eps * 10)) < 1e-6:
            curve.append(row)
        if best is None or f1 > best["f1"]:
            best = dict(row)
    best["curve"] = curve
    best.update(head)
    best.update(points=int(len(s)), unstable_frac=round(float(lbl.mean()), 4),
                score_mean_stable=round(float(s[~lbl].mean()), 4),
                score_mean_unstable=round(float(s[lbl].mean()), 4))
    return best


def sequence_scores(filt, scans, poses, scan_points, which) -> tuple[np.ndarray, np.ndarray]:
    """The filter's scores of the scans `which` (each cut to scan_points,
    at its pose) and their labels > 0.5, concatenated over the scans."""
    pend = []
    for i in which:
        scan = scans[i]
        n = min(len(scan), scan_points)
        sx = np.zeros((scan_points, 3), np.float32)
        sl = np.zeros((scan_points,), np.float32)
        sv = np.zeros((scan_points,), bool)
        sx[:n], sl[:n], sv[:n] = scan[:n, :3], scan[:n, 3], True
        scores, _, _ = filt(sx, sv, sl, poses[i].astype(np.float32))
        pend.append((scores, sl[:n].copy(), n))
    s = np.concatenate([sc[:n].float().cpu().numpy() for sc, _, n in pend])
    lbl = np.concatenate([lab for _, lab, _ in pend]) > 0.5
    return s, lbl


def calibrate(cfg, state_dict, sequence=None, max_scans=None, filt=None, device=None):
    """The max-F1 epsilon on `sequence` (default the first VAL one) over
    max_scans scans spread evenly over it (all of them when None), with
    `filt` or a new StreamingFilter on the map. Returns (sweep_epsilon's
    dict with the sequence, the filter)."""
    from sps_torch.data import blt
    from sps_torch.stream.engine import StreamingFilter

    seq = sequence or cfg.data.val[0]
    scans, poses = blt.load_sequences_raw(cfg.data.root, [seq])
    if filt is None:
        filt = StreamingFilter(cfg, state_dict, blt.load_map(cfg.data.root, cfg.data.map_file),
                               device=device)
    if max_scans is None:
        which = range(len(scans))
    else:
        which = np.linspace(0, len(scans) - 1, min(max_scans, len(scans))).astype(int)
    s, lbl = sequence_scores(filt, scans, poses, cfg.tpu.scan_points, which)
    return sweep_epsilon(s, lbl, sequence=seq), filt


def main(argv=None):
    from sps_torch import config as cfg_mod
    from sps_torch import convert
    from sps_torch.structs import resolve_device

    ap = argparse.ArgumentParser(description="Max-F1 filter threshold on the val split.")
    ap.add_argument("-c", "--config", default="./config/config_loc.yaml")
    ap.add_argument("-w", "--weights", required=True)
    ap.add_argument("--data", default=None, help="dataset root (defaults to $DATA)")
    ap.add_argument("-seq", "--sequence", default=None,
                    help="default: the config VAL split's first sequence")
    ap.add_argument("--max-scans", type=int, default=12)
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' for the CPU")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    cfg = cfg_mod.load(args.config, data_root=args.data)
    sd = convert.load_weights(args.weights, cfg.sps_config(1))
    best, _ = calibrate(cfg, sd, args.sequence, args.max_scans, device=args.device)
    print(json.dumps(best))
    return best


if __name__ == "__main__":
    main()
