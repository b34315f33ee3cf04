"""Streaming baseline filters: MOS4D, MapMOS, LTS and the voxel mask
(counterpart of sps_tpu/stream/baselines.py).

  * MOS4DFilter: a sliding buffer of N world-frame scans merged into one 4D
    cloud (the buffer index is the time slot); keeps the newest scan's
    points whose moving logit is <= 0.
  * MapMOSFilter: the scan against a 30 m crop of the map, subsampled to
    capacity with numpy's Generator(counter) (the same draw as sps_tpu's),
    scan index = counter, map index = -1.
  * LTSFilter: range image -> azimuth windows -> SPCTReg; keeps occupied
    image points whose score is <= epsilon (range-image resampled points).
  * MaskFilter: keeps the scan points whose voxel holds a map point: exact
    membership of packed voxel keys in the map's sorted keys
    (torch.searchsorted; sps_tpu probes a hash table).

Each filter runs on the card unless device="cpu" is passed. The models run
on the device; only bookkeeping (the map crop and subsample, the range
image, the returned masks) is host numpy, as in sps_tpu.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from sps_torch.data import range_image as ri
from sps_torch.models.lts import SPCTReg
from sps_torch.models.mapmos import MapMOSConfig, MapMOSNet
from sps_torch.models.mos4d import MOS4DConfig, MOS4DNet
from sps_torch.ops import voxelize as vox
from sps_torch.structs import PointBatch, resolve_device
from sps_torch.utils.geometry import transform_points


def scans_from_ckpt_name(path: str, default: int = 10) -> int:
    """Buffer length from a `<N>_scans.ckpt` name (the reference's rule)."""
    m = re.search(r"(\d+)_scans", path)
    return int(m.group(1)) if m else default


def _load(model: torch.nn.Module, state_dict: dict, device) -> torch.nn.Module:
    model.load_state_dict(state_dict, strict=True)
    return model.to(device).eval()


def _point_batch(xyz, t, valid) -> PointBatch:
    n = xyz.shape[0]
    return PointBatch(xyz=xyz, batch=torch.zeros(n, dtype=torch.int32, device=xyz.device), t=t,
                      label=torch.zeros(n, dtype=torch.float32, device=xyz.device), valid=valid)


class MOS4DFilter:
    """Sliding N-scan buffer; a call returns the keep mask of the newest scan
    (moving points dropped)."""

    def __init__(self, cfg: MOS4DConfig, state_dict: dict, scan_capacity: int, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.ns = scan_capacity
        self.buffer: list[torch.Tensor] = []  # world-frame scans on the device
        self.model = _load(MOS4DNet(cfg), state_dict, self.device)

    def logits(self) -> torch.Tensor:
        """The buffer through MOS4DNet: (n_scans * ns,) logits, scan i in rows
        [i * ns, i * ns + len)."""
        nt = self.cfg.n_scans * self.ns
        dev = self.device
        xyz = torch.zeros((nt, 3), dtype=torch.float32, device=dev)
        t = torch.zeros(nt, dtype=torch.int32, device=dev)
        valid = torch.zeros(nt, dtype=torch.bool, device=dev)
        for i, s in enumerate(self.buffer):
            k = min(len(s), self.ns)
            o = i * self.ns
            xyz[o:o + k] = s[:k]
            t[o:o + k] = i
            valid[o:o + k] = True
        with torch.inference_mode():
            return self.model(_point_batch(xyz, t, valid))[0]

    def push(self, scan_xyz: np.ndarray, pose: np.ndarray) -> torch.Tensor:
        """Buffer a scan (n, 3) in the sensor frame (the oldest drops out
        past n_scans); returns the newest scan's (min(n, ns),) logits."""
        world = transform_points(torch.as_tensor(scan_xyz, device=self.device),
                                 torch.as_tensor(pose, device=self.device))
        self.buffer.append(world)
        if len(self.buffer) > self.cfg.n_scans:
            self.buffer.pop(0)
        o = (len(self.buffer) - 1) * self.ns
        return self.logits()[o:o + min(len(scan_xyz), self.ns)]

    def __call__(self, scan_xyz: np.ndarray, pose: np.ndarray) -> np.ndarray:
        """scan_xyz (n, 3) in the sensor frame -> (min(n, ns),) keep mask
        of the newest scan (True = static: logit <= 0)."""
        return (self.push(scan_xyz, pose) <= 0).cpu().numpy()


class MapMOSFilter:
    """The scan and a radius crop of the map through MapMOSNet."""

    def __init__(self, cfg: MapMOSConfig, state_dict: dict, map_points: np.ndarray,
                 scan_capacity: int, map_capacity: int, crop_radius: float = 30.0,
                 device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.map_points = np.asarray(map_points, np.float32)[:, :3]
        self.ns = scan_capacity
        self.nm = map_capacity
        self.crop = crop_radius
        self.counter = 0
        self.model = _load(MapMOSNet(cfg), state_dict, self.device)

    def local_map(self, center: np.ndarray) -> np.ndarray:
        """Map points within the crop radius of `center`, subsampled to the
        map capacity without replacement by Generator(counter): map arrays
        are spatially ordered, so truncating would keep one side."""
        d = np.linalg.norm(self.map_points - center[None], axis=1)
        local = self.map_points[d < self.crop]
        if len(local) > self.nm:
            sel = np.random.default_rng(self.counter).choice(len(local), self.nm, replace=False)
            local = local[sel]
        return local

    def logits(self, world: torch.Tensor, local: np.ndarray) -> torch.Tensor:
        """The scan (world frame, on the device) and the local map through
        MapMOSNet: (ns + nm,) logits, the scan in the first rows."""
        nt = self.ns + self.nm
        dev = self.device
        xyz = torch.zeros((nt, 3), dtype=torch.float32, device=dev)
        t = torch.zeros(nt, dtype=torch.int32, device=dev)
        valid = torch.zeros(nt, dtype=torch.bool, device=dev)
        idx = torch.zeros(nt, dtype=torch.float32, device=dev)
        n = min(len(world), self.ns)
        m = len(local)
        xyz[:n] = world[:n]
        t[:n] = 1
        valid[:n] = True
        idx[:n] = self.counter
        xyz[self.ns:self.ns + m] = torch.as_tensor(local, device=dev)
        valid[self.ns:self.ns + m] = True
        idx[self.ns:self.ns + m] = -1.0
        with torch.inference_mode():
            return self.model(_point_batch(xyz, t, valid), idx)[0]

    def push(self, scan_xyz: np.ndarray, pose: np.ndarray) -> torch.Tensor:
        """A scan (n, 3) in the sensor frame against the map around its pose
        (the call counts as scan `counter`); returns its (min(n, ns),) logits."""
        world = transform_points(torch.as_tensor(scan_xyz, device=self.device),
                                 torch.as_tensor(pose, device=self.device))
        lg = self.logits(world, self.local_map(np.asarray(pose)[:3, 3]))
        self.counter += 1
        return lg[:min(len(scan_xyz), self.ns)]

    def __call__(self, scan_xyz: np.ndarray, pose: np.ndarray) -> np.ndarray:
        """(min(n, ns),) keep mask of the scan (True = static: logit <= 0)."""
        return (self.push(scan_xyz, pose) <= 0).cpu().numpy()


class LTSFilter:
    """Range-image LTS filter: project -> window -> SPCTReg -> threshold."""

    def __init__(self, state_dict: dict, lidar: str = "vlp-16", epsilon: float = 0.84,
                 device=None):
        self.device = resolve_device(device)
        self.lidar = lidar
        self.eps = epsilon
        self.model = _load(SPCTReg(), state_dict, self.device)

    def scores(self, wins: np.ndarray) -> torch.Tensor:
        """(num_windows, P, 3) window points -> (num_windows, P) scores."""
        with torch.inference_mode():
            return self.model(torch.as_tensor(wins, device=self.device))

    def __call__(self, scan: np.ndarray) -> np.ndarray:
        """scan (N, 4) [x, y, z, label] -> the kept (M, 4) [x, y, z, score]
        range-image points."""
        wins, _ = ri.windows(ri.project(scan, self.lidar), self.lidar)
        s = self.scores(wins).reshape(-1).cpu().numpy()
        pts = wins.reshape(-1, 3)
        keep = (s <= self.eps) & (np.abs(pts).sum(axis=1) > 0)
        return np.column_stack([pts[keep], s[keep]])


# Voxel keys pack three coordinates in [-KEY_OFFSET, KEY_OFFSET) into 21 bits
# each (+-2^20 voxels: 105 km at 0.1 m).
KEY_OFFSET = 1 << 20


def _voxel_keys(coords: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, 3) int32 voxel coords -> ((N,) int64 keys, (N,) in-range mask)."""
    c = coords.long() + KEY_OFFSET
    ok = ((c >= 0) & (c < 2 * KEY_OFFSET)).all(dim=1)
    return (c[:, 0] << 42) | (c[:, 1] << 21) | c[:, 2], ok


class MaskFilter:
    """Model-free voxel-overlap filter: keep the scan points whose voxel (at
    voxel_size) holds at least one map point."""

    def __init__(self, map_points: np.ndarray, voxel_size: float, device=None):
        self.device = resolve_device(device)
        self.vs = voxel_size
        pts = torch.as_tensor(np.asarray(map_points, np.float32)[:, :3], device=self.device)
        keys, ok = _voxel_keys(vox.quantize(pts, voxel_size))
        if not bool(ok.all()):
            raise ValueError(f"map voxels beyond +-{KEY_OFFSET} at voxel size {voxel_size}")
        self.keys = torch.unique(keys)  # sorted

    def keep(self, scan_xyz: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
        """(N, 3) sensor-frame points and a pose on the device -> (N,) bool:
        the posed point's voxel holds a map point."""
        q, ok = _voxel_keys(vox.quantize(transform_points(scan_xyz, pose), self.vs))
        i = torch.searchsorted(self.keys, q).clamp_max(len(self.keys) - 1)
        return ok & (self.keys[i] == q)

    def __call__(self, scan_xyz: np.ndarray, pose: np.ndarray) -> np.ndarray:
        return self.keep(torch.as_tensor(scan_xyz, dtype=torch.float32, device=self.device),
                         torch.as_tensor(pose, dtype=torch.float32, device=self.device)
                         ).cpu().numpy()
