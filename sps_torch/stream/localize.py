"""Offline localization: filter -> scan-to-map registration -> ATE
(counterpart of sps_tpu/stream/localize.py).

Per sequence and filter, replay the scans, filter each one, register the
kept points against the map (register.register_pyramid on a 16x / 4x voxel
pyramid) and score the trajectory's absolute translation error against the
ground truth. The pose prior is the noisy ground truth ("odom") or a
damped constant-velocity prediction from the past estimates ("cv").

Filters: "raw" (every point), "oracle" (the ground-truth stable points),
"sps" (the streaming filter's keep at epsilon) and "sps-soft" (every point,
weighted by (1 - score)^2). The baselines "mask", "mos4d", "mapmos" and
"lts" are not ported yet (ROADMAP, modules to port: the baselines).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sps_torch import register as reg
from sps_torch.config import Config
from sps_torch.data import blt
from sps_torch.stream.engine import StreamingFilter
from sps_torch.structs import resolve_device

FILTERS = ("sps", "sps-soft", "mask", "raw", "mos4d", "mapmos", "lts", "oracle")
PORTED = ("sps", "sps-soft", "raw", "oracle")
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


def run_localization(cfg: Config, state_dict: dict, sequence: str, filter_mode: str = "sps",
                     init_noise: float = 0.0, prior: str = "cv",
                     seed: int = 0, epsilon: float | None = None, refine: bool = True,
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
    (shared across calls) holds the registration maps and the filter."""
    if filter_mode not in FILTERS:
        raise ValueError(f"unknown filter {filter_mode!r}; one of {FILTERS}")
    if filter_mode not in PORTED:
        raise NotImplementedError(
            f"filter {filter_mode!r} is not ported yet (ROADMAP, modules to port: the baselines)")
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

            def apply_filter(at_pose):
                if filter_mode == "sps":
                    _, keep_d, _ = filt(sx, sv, sl, at_pose.astype(np.float32))
                    return keep_d.cpu().numpy()
                return sv

            def guard(k):
                return sv.copy() if k.sum() < GUARD_FLOOR * sv.sum() else k

            keep = sv
            point_w = None
            cv_raw_first = prior == "cv" and i > 1 and filter_mode in POSE_CONSUMING
            if filter_mode == "oracle":
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
                kept2 = apply_filter(est0) & sv
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
