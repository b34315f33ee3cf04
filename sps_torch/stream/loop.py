"""Fused localization loop: filter -> register with device-resident pose
state (counterpart of sps_tpu/stream/loop.py).

Per scan, in one call that reads nothing back from the device:

  cv prior (from the last two estimates, on the device)
  -> streaming filter at the prior          (stream/engine.py programs)
  -> coarse -> fine ICP + yaw search        (register.register_pyramid)
  [-> refilter at the estimate -> register] (refine=True)

so consecutive scans chain launch after launch; the consumer reads poses
one scan behind. The refine pass runs the reuse program on the topology
of the same call's first pass (the pose moves centimetres), so it costs
one network, not a rebuild; without topology reuse (TOPO_EVERY 0) it
rebuilds, as sps_tpu does.

The cv prior composes the last relative motion, damped: prev @
exp(0.85 * log(prev2^-1 prev)); the prior lags a true constant velocity by
0.15 of a step, which caps the loop gain (see _cv_guess).

Profiler ranges: "sps.loop.filter" and "sps.loop.icp" around each pass.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from sps_torch import register as reg
from sps_torch.config import Config
from sps_torch.stream.engine import StreamingFilter
from sps_torch.structs import resolve_device


def _se3_inv(p: torch.Tensor) -> torch.Tensor:
    r, t = p[:3, :3], p[:3, 3]
    top = torch.cat([r.T, (-r.T @ t)[:, None]], 1)
    return torch.cat([top, p[3:]], 0)


def _se3_log(p: torch.Tensor) -> torch.Tensor:
    """4x4 -> (6,) [omega, v] se(3) logarithm (rotation angles < pi); the
    series limits below 1e-6 rad."""
    r, t = p[:3, :3], p[:3, 3]
    cos_th = torch.clamp((r[0, 0] + r[1, 1] + r[2, 2] - 1.0) * 0.5, -1.0, 1.0)
    th = torch.arccos(cos_th)
    sin_th = torch.sin(th)
    small = th > 1e-6
    scale = torch.where(small, th / torch.clamp_min(2.0 * sin_th, 1e-12), 0.5)
    w = scale * torch.stack([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]])
    kx = reg._skew(w)
    th2 = torch.clamp_min(th * th, 1e-12)
    a = torch.where(small, (1.0 - th * sin_th / (2.0 * (1.0 - cos_th + 1e-12))) / th2,
                    1.0 / 12.0)
    vinv = torch.eye(3, dtype=p.dtype, device=p.device) - 0.5 * kx + a * (kx @ kx)
    return torch.cat([w, vinv @ t])


def _cv_guess(poses: torch.Tensor, damp: float = 0.85) -> torch.Tensor:
    """poses (2, 4, 4): the last two estimates -> damped constant-velocity
    prediction prev @ exp(damp * log(prev2^-1 prev)). Undamped (damp = 1),
    a consistent sub-voxel registration bias becomes a velocity and the
    offset compounds; the damping caps that gain."""
    delta = _se3_inv(poses[0]) @ poses[1]
    return poses[1] @ reg._exp_se3(damp * _se3_log(delta))


class LocalizationLoop:
    """The resident map (filter atlas + registration pyramid) and the pose
    state of the last two estimates, on the device.

    Call once per scan: loop(scan, valid, labels, prior=pose4x4) for the
    externally seeded scans (the cv prior needs two estimates), then
    loop(scan, valid, labels). Returns (pose, keep, stats) as device
    tensors. Runs on the card unless device="cpu" is passed."""

    def __init__(self, cfg: Config, state_dict: dict, map_points: np.ndarray, *,
                 refine: bool = True, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.refine = refine
        self.filt = StreamingFilter(cfg, state_dict, map_points, device=self.device)
        self.vmaps = reg.build_pyramid(map_points, cfg.voxel_size, device=self.device)
        self._eye = torch.eye(4, device=self.device)
        self.invalidate()

    def _filter(self, x, v, lab, pose, cache):
        """One filter pass at `pose`: the reuse program on `cache`, else a
        rebuild. Returns (keep, stats, cache); the cache only with topology
        reuse on."""
        a = (x[None], v[None], lab[None], pose[None])
        with record_function("sps.loop.filter"):
            if cache is not None:
                _, keep, stats = self.filt._reuse(*cache, *a)
            else:
                _, keep, stats, cache = self.filt._rebuild(*a)
                if self.filt.topo_every <= 0:
                    cache = None
        return keep[0], stats, cache

    def _register(self, x, keep, pose, yaw):
        with record_function("sps.loop.icp"):
            return reg.register_pyramid(self.vmaps, x, keep, pose, yaw=yaw)

    def __call__(self, scan, valid, labels, prior=None):
        dev = self.device
        x = torch.as_tensor(scan, dtype=torch.float32, device=dev)
        v = torch.as_tensor(valid, dtype=torch.bool, device=dev)
        lab = torch.as_tensor(labels, dtype=torch.float32, device=dev)
        prior_t = (self._eye if prior is None
                   else torch.as_tensor(prior, dtype=torch.float32, device=dev))
        if self._state is None:
            self._state = torch.stack([prior_t, prior_t])
        topo = self.filt.topo_every > 0
        reuse = topo and self._cache is not None and self._i % self.filt.topo_every != 0
        self._i += 1
        with torch.inference_mode():
            use_prior = torch.full((), prior is not None, dtype=torch.bool, device=dev)
            guess = torch.where(use_prior, prior_t, _cv_guess(self._state))
            keep, fstats, cache = self._filter(x, v, lab, guess, self._cache if reuse else None)
            pose, rstats = self._register(x, keep & v, guess, True)
            if self.refine:
                # Refilter at the estimate on this call's topology (the pose
                # moves centimetres; misses are counted).
                keep, fstats, _ = self._filter(x, v, lab, pose, cache)
                pose, rstats = self._register(x, keep & v, pose, False)
            if not reuse:
                self._cache = cache
            self._state = torch.stack([self._state[1], pose])
        stats = {
            "inliers": rstats["inliers"],
            "reg_rmse": rstats["rmse"],
            "n_kept": fstats["n_kept"],
            "overflow": fstats["overflow"],
            # The hash engines rebuild every scan and count no misses.
            "topo_miss_points": fstats.get("topo_miss_points",
                                           torch.zeros((), dtype=torch.int32, device=dev)),
        }
        return pose, keep, stats

    def invalidate(self):
        """Forget the topology cache and the pose state."""
        self._cache = None
        self._i = 0
        self._state = None
