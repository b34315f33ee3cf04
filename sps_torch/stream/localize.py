"""Offline localization: filter -> scan-to-map registration -> ATE
(counterpart of sps_tpu/stream/localize.py).

Per sequence and filter, replay the scans, filter each one, register the
kept points against the map (register.register_pyramid on a 16x / 4x voxel
pyramid) and score the trajectory's absolute translation error against the
ground truth. The pose prior is the noisy ground truth ("odom") or a
damped constant-velocity prediction from the past estimates ("cv").

Filters: "raw" (every point), "oracle" (the ground-truth stable points),
"sps" (the streaming filter's keep at epsilon), "sps-soft" (every point,
weighted by (1 - score)^2), and the baselines of stream/baselines.py:
"mask" (the map-voxel overlap), "mos4d" (a 4-scan buffer), "mapmos" (the
scan against a 30 m map crop) and "lts" (range-image windows at epsilon;
it registers its resampled kept points). The baselines' weights are
the checkpoints <model>.pt of sps_torch.scripts.train_baselines or npz
files (scripts/export_torch_assets.py writes the round-5 ones to
sps_torch/assets/baselines_r5_<model>.npz); without them the models take
seeded random weights.

    python -m sps_torch.stream.localize -c config/config_loc_movers_v2.yaml \
        -w sps_torch/assets/ckpt_loc_movers_v2.npz -seq 20220629 --data DIR \
        --filter mos4d --baseline-weights sps_torch/assets [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os

import numpy as np
import torch

from sps_torch import convert
from sps_torch import register as reg
from sps_torch.config import Config
from sps_torch.data import blt
from sps_torch.models import lts
from sps_torch.models.mapmos import MapMOSConfig, MapMOSNet
from sps_torch.models.mos4d import MOS4DConfig, MOS4DNet
from sps_torch.stream import baselines as bl
from sps_torch.stream.engine import StreamingFilter
from sps_torch.structs import resolve_device
from sps_torch.utils import checkpoint

FILTERS = ("sps", "sps-soft", "mask", "raw", "mos4d", "mapmos", "lts", "oracle")
BASELINES = ("mos4d", "mapmos", "lts")
MOS4D_SCANS = 4  # the localization driver's MOS4D buffer
# Filters whose keep decision depends on the pose they are evaluated at.
POSE_CONSUMING = ("sps", "sps-soft", "mask", "mos4d", "mapmos")
# Below this share of the valid points a pose-consuming filter abstains for
# the scan and the raw cloud registers instead.
GUARD_FLOOR = 0.15


def ate_rmse(est: np.ndarray, gt: np.ndarray) -> float:
    """Absolute trajectory error on translation, no alignment."""
    d = est[:, :3, 3] - gt[:, :3, 3]
    return float(np.sqrt((d**2).sum(-1).mean()))


def _se3_log_np(p: np.ndarray) -> np.ndarray:
    """4x4 -> (6,) [omega, v]; valid for rotation angles < pi."""
    r = p[:3, :3]
    t = p[:3, 3]
    cos_th = np.clip((np.trace(r) - 1.0) * 0.5, -1.0, 1.0)
    th = float(np.arccos(cos_th))
    if th < 1e-8:
        return np.concatenate([np.zeros(3), t])
    w = th / (2.0 * np.sin(th)) * np.array([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0],
                                            r[1, 0] - r[0, 1]])
    kx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0.0]])
    a = (1.0 - th * np.sin(th) / (2.0 * (1.0 - np.cos(th)))) / (th * th)
    vinv = np.eye(3) - 0.5 * kx + a * (kx @ kx)
    return np.concatenate([w, vinv @ t])


def _se3_exp_np(x: np.ndarray) -> np.ndarray:
    w, v = x[:3], x[3:]
    th = float(np.linalg.norm(w))
    out = np.eye(4)
    if th < 1e-8:
        out[:3, 3] = v
        return out
    k = w / th
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0.0]])
    s, c = np.sin(th), np.cos(th)
    out[:3, :3] = np.eye(3) + s * kx + (1 - c) * (kx @ kx)
    vmat = np.eye(3) + ((1 - c) / th) * kx + ((th - s) / th) * (kx @ kx)
    out[:3, 3] = vmat @ v
    return out


def cv_predict(poses: list[np.ndarray], k: int = 3, damp: float = 0.85) -> np.ndarray:
    """Constant-velocity prior: the mean (in se(3) log coordinates) of the
    last k relative motions, damped by `damp`, composed onto the last pose
    (the same damping as stream/loop.py's _cv_guess)."""
    if len(poses) == 0:
        return np.eye(4)
    if len(poses) == 1:
        return poses[-1]
    rel = [np.linalg.inv(poses[i - 1]) @ poses[i]
           for i in range(max(1, len(poses) - k), len(poses))]
    mean_log = np.mean([_se3_log_np(d) for d in rel], axis=0)
    return poses[-1] @ _se3_exp_np(damp * mean_log)


def _baseline_state_dict(weights_dir: str | None, mode: str) -> dict | None:
    """The state_dict of baseline `mode` from `weights_dir`: its `<mode>.pt`
    (sps_torch.scripts.train_baselines' checkpoint) or the npz whose name
    ends in `<mode>.npz` (an export of sps_tpu's); None without a directory.
    Raises when the directory holds neither, both, or more than one npz, so
    that no file is picked silently."""
    if not weights_dir:
        return None
    pt = os.path.join(weights_dir, f"{mode}.pt")
    found = sorted(glob.glob(os.path.join(weights_dir, f"*{mode}.npz")))
    if os.path.exists(pt):
        if found:
            raise FileExistsError(f"{weights_dir} holds both {mode}.pt and {found}: "
                                  "which weights to use is ambiguous")
        return checkpoint.restore(pt)["model"]
    if len(found) != 1:
        raise FileNotFoundError(f"want {mode}.pt or one *{mode}.npz in {weights_dir}, "
                                f"found {found}")
    return convert.load_baseline_npz(found[0], mode)


def _make_baseline_filter(cfg: Config, mode: str, map_points: np.ndarray,
                          weights_dir: str | None = None, device=None):
    """A baseline filter at the driver's settings: MOS4D on a 4-scan buffer,
    MapMOS on SCAN_POINTS + SUBMAP_POINTS, LTS at cfg.threshold. Weights
    from `weights_dir`, else seeded random ones (seed 0)."""
    ns = cfg.tpu.scan_points
    caps = cfg.sps_config(batch_size=1).caps
    sd = _baseline_state_dict(weights_dir, mode)
    if mode == "mos4d":
        mcfg = MOS4DConfig(voxel_size=cfg.voxel_size, n_scans=MOS4D_SCANS, caps=caps)
        if sd is None:
            sd = MOS4DNet(mcfg, torch.Generator().manual_seed(0)).state_dict()
        return bl.MOS4DFilter(mcfg, sd, ns, device=device)
    if mode == "mapmos":
        mcfg = MapMOSConfig(voxel_size=cfg.voxel_size, caps=caps)
        if sd is None:
            sd = MapMOSNet(mcfg, torch.Generator().manual_seed(0)).state_dict()
        return bl.MapMOSFilter(mcfg, sd, map_points, ns, cfg.tpu.submap_points, device=device)
    if mode == "lts":
        return bl.LTSFilter(lts.init_state_dict(0) if sd is None else sd,
                            epsilon=cfg.threshold, device=device)
    raise ValueError(mode)


def run_localization(cfg: Config, state_dict: dict, sequence: str, filter_mode: str = "sps",
                     init_noise: float = 0.0, prior: str = "cv",
                     seed: int = 0, baseline_weights: str | None = None,
                     epsilon: float | None = None, refine: bool = True,
                     cache: dict | None = None, log=print, device=None) -> dict:
    """Localize one sequence; returns {ate_rmse, kept_frac_mean, the knobs,
    and per scan: poses (n, 4, 4) and kept_frac}.

    prior "odom": the ground truth plus N(0, init_noise) on the translation
    per scan; "cv": the ground truth (with that noise) for scans 0 and 1,
    then cv_predict of the estimates. Pose-consuming filters under "cv"
    register unfiltered first and filter at that estimate (cv raw-first);
    otherwise, with `refine`, they re-filter at the registered pose and
    register once more when the keep count holds. A filter that keeps less
    than GUARD_FLOOR of the valid points abstains for the scan. `cache`
    (shared across calls) holds the registration maps and the filters; a
    cached MOS4D filter starts each call with an empty buffer, a cached
    MapMOS filter keeps counting its scans. `baseline_weights`: a directory
    of baseline checkpoints or npz files (see _baseline_state_dict)."""
    if filter_mode not in FILTERS:
        raise ValueError(f"unknown filter {filter_mode!r}; one of {FILTERS}")
    dev = resolve_device(device)
    if epsilon is not None:
        cfg = dataclasses.replace(cfg, threshold=epsilon)
    cache = cache if cache is not None else {}
    scans, gt_poses = blt.load_sequences_raw(cfg.data.root, [sequence])
    map_points = blt.load_map(cfg.data.root, cfg.data.map_file)
    if "vmaps" not in cache:
        cache["vmaps"] = reg.build_pyramid(map_points, cfg.voxel_size, device=dev)
    vmaps = cache["vmaps"]
    filt = None
    if filter_mode in ("sps", "sps-soft"):
        if "sps" not in cache:
            cache["sps"] = StreamingFilter(cfg, state_dict, map_points, device=dev)
        filt = cache["sps"]
        filt.eps = cfg.threshold
    elif filter_mode == "mask":
        # The reference's mask node: keep the points whose voxel (at
        # VOXEL_SIZE) holds a map point.
        if "mask" not in cache:
            cache["mask"] = bl.MaskFilter(map_points, cfg.voxel_size, device=dev)
        filt = cache["mask"]
    elif filter_mode in BASELINES:
        if filter_mode in cache:
            filt = cache[filter_mode]
            if isinstance(filt, bl.MOS4DFilter):
                filt.buffer = []  # a fresh sequence
        else:
            filt = cache[filter_mode] = _make_baseline_filter(
                cfg, filter_mode, map_points, weights_dir=baseline_weights, device=dev)
    ns = cfg.tpu.scan_points
    rng = np.random.default_rng(seed)

    def do_reg(sx_t, kmask, at, w=None):
        pose, stats = reg.register_pyramid(
            vmaps, sx_t, torch.as_tensor(kmask, device=dev),
            torch.as_tensor(at.astype(np.float32), device=dev),
            point_w=None if w is None else torch.as_tensor(w, device=dev))
        return pose.cpu().numpy(), stats

    est_list: list[np.ndarray] = []
    kept_frac = []
    with torch.inference_mode():
        for i, scan in enumerate(scans):
            n = min(len(scan), ns)
            sx = np.zeros((ns, 3), np.float32)
            sl = np.zeros((ns,), np.float32)
            sv = np.zeros((ns,), bool)
            sx[:n], sl[:n], sv[:n] = scan[:n, :3], scan[:n, 3], True
            sx_t = torch.as_tensor(sx, device=dev)

            # cv needs two estimates: scans 0 and 1 take the external prior.
            if i <= 1 or prior == "odom":
                guess = gt_poses[i].copy()
                if init_noise:
                    guess[:3, 3] += rng.normal(0, init_noise, 3)
            else:
                guess = cv_predict(est_list)

            def soft_weights(at_pose):
                scores, _, _ = filt(sx, sv, sl, at_pose.astype(np.float32))
                w = (1.0 - scores.float().cpu().numpy()) ** 2
                return (w * sv).astype(np.float32)

            def apply_filter(at_pose, rerun=False):
                if filter_mode == "sps":
                    _, keep_d, _ = filt(sx, sv, sl, at_pose.astype(np.float32))
                    return keep_d.cpu().numpy()
                if filter_mode == "mask":
                    return filt.keep(sx_t, torch.as_tensor(at_pose.astype(np.float32),
                                                           device=dev)).cpu().numpy() & sv
                if filter_mode in ("mos4d", "mapmos"):
                    if rerun and isinstance(filt, bl.MOS4DFilter):
                        filt.buffer.pop()  # the rerun replaces the newest buffered scan
                    km = filt(scan[:n, :3].astype(np.float32), at_pose.astype(np.float32))
                    keep = sv.copy()
                    keep[:n] &= km[:n]
                    return keep
                return sv

            def guard(k):
                return sv.copy() if k.sum() < GUARD_FLOOR * sv.sum() else k

            keep = sv
            point_w = None
            cv_raw_first = prior == "cv" and i > 1 and filter_mode in POSE_CONSUMING
            if filter_mode == "lts":
                # LTS resamples through the range image: register its kept
                # points.
                kept_pts = filt(scan[:n, :4].astype(np.float32))
                m = min(len(kept_pts), ns)
                sx = np.zeros((ns, 3), np.float32)
                sx[:m] = kept_pts[:m, :3]
                sv = np.zeros((ns,), bool)
                sv[:m] = True
                sx_t = torch.as_tensor(sx, device=dev)
                keep = sv
            elif filter_mode == "oracle":
                keep = sv & (sl < 0.5)
            elif cv_raw_first:
                keep = sv
            elif filter_mode == "sps-soft":
                point_w = soft_weights(guess)
                if point_w.sum() < GUARD_FLOOR * sv.sum():
                    point_w = None
            else:
                keep = guard(apply_filter(guess))

            kept = keep & sv
            pose, stats_r = do_reg(sx_t, kept, guess, point_w)
            if cv_raw_first:
                est0 = pose
                if filter_mode == "sps-soft":
                    point_w = soft_weights(est0)
                    if point_w.sum() < GUARD_FLOOR * sv.sum():
                        point_w = None
                    pose, stats_r = do_reg(sx_t, kept, est0, point_w)
                else:
                    kept = guard(apply_filter(est0)) & sv
                    pose, stats_r = do_reg(sx_t, kept, est0)
            elif refine and filter_mode == "sps-soft":
                est0 = pose
                w2 = soft_weights(est0)
                if w2.sum() >= GUARD_FLOOR * sv.sum():
                    point_w = w2
                    pose, stats_r = do_reg(sx_t, kept, est0, point_w)
            elif refine and filter_mode in POSE_CONSUMING:
                est0 = pose
                kept2 = apply_filter(est0, rerun=True) & sv
                # A halved keep count means the estimate moved away from the
                # overlap: keep the first registration then.
                if kept2.sum() >= max(0.5 * kept.sum(), GUARD_FLOOR * sv.sum()):
                    kept = kept2
                    pose, stats_r = do_reg(sx_t, kept, est0)
            if filter_mode == "sps-soft" and point_w is not None:
                kept_frac.append(point_w.sum() / max(sv.sum(), 1))
            else:
                kept_frac.append(kept.sum() / max(sv.sum(), 1))
            est_list.append(pose)
            terr = np.linalg.norm(pose[:3, 3] - gt_poses[i][:3, 3])
            log(f"[{filter_mode}] scan {i}: terr={terr:.3f} kept={kept_frac[-1]:.2f} "
                f"inliers={int(stats_r['inliers'])} rmse={float(stats_r['rmse']):.3f}")

    est = np.stack(est_list)
    return {
        "filter": filter_mode,
        "ate_rmse": ate_rmse(est, np.stack(gt_poses)),
        "kept_frac_mean": float(np.mean(kept_frac)),
        "n_scans": len(scans),
        "prior": prior,
        "epsilon": float(cfg.threshold),
        "init_noise": float(init_noise),
        "refine": bool(refine),
        "icp_iters": reg.ICP_ITERS,
        "seed": int(seed),
        "cv_raw_first": prior == "cv" and filter_mode in POSE_CONSUMING,
        "poses": est,
        "kept_frac": np.asarray(kept_frac, np.float64),
    }


def main(argv=None):
    from sps_torch import config as cfg_mod
    from sps_torch.models import spsnet

    ap = argparse.ArgumentParser(description="Localize a sequence: filter, register, ATE.")
    ap.add_argument("-c", "--config", default="./config/config.yaml")
    ap.add_argument("-w", "--weights", default=None,
                    help="SPS weights (.npz, best.pt or a reference .ckpt); default: seeded "
                         "random ones")
    ap.add_argument("-seq", "--sequence", required=True)
    ap.add_argument("--data", default=None, help="dataset root (defaults to $DATA)")
    ap.add_argument("--filter", dest="filter_mode", choices=FILTERS, default="sps")
    ap.add_argument("--init-noise", type=float, default=0.0)
    ap.add_argument("--baseline-weights", default=None,
                    help="directory of the baselines' <model>.pt (train_baselines) or "
                         "<model>.npz (e.g. sps_torch/assets); "
                         "default: seeded random weights")
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' for the CPU")
    args = ap.parse_args(argv)
    cfg = cfg_mod.load(args.config, data_root=args.data)
    sd = (convert.load_weights(args.weights, cfg.sps_config(1)) if args.weights
          else spsnet.init_state_dict(cfg.sps_config(1)))
    out = run_localization(cfg, sd, args.sequence, args.filter_mode, init_noise=args.init_noise,
                           baseline_weights=args.baseline_weights, device=args.device)
    out = {k: v.tolist() if isinstance(v, np.ndarray) else v for k, v in out.items()}
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
