"""Streaming per-scan filter engine (counterpart of sps_tpu/stream/engine.py,
atlas engine).

Per scan: pose the scan into the map frame; voxelize into atlas bricks
with T=2 time slots; set the map-overlap bit with one gather into the
resident map atlas; build (or refresh) the topology pyramid; MinkUNet
stability scores devoxelized to points; loss/R2/dIoU stats against the
labels; keep points with score <= eps.

Topology reuse (TOPO_EVERY): every `topo_every`-th dispatch rebuilds the
pyramid and caches it; the dispatches in between refresh the cached
pyramid's occupancy instead. Points whose brick the cache does not cover
score sigmoid(0) = 0.5 and are counted in stats["topo_miss_points"].

Everything per scan stays on the device: capacities are static, overflow
is data, and no value is read back to the host. Profiler ranges
("sps.rebuild" / "sps.reuse", "sps.model", and per-stage ranges inside
MinkUNet) label the work in a torch.profiler trace; without a profiler
they cost a few microseconds per scan.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from sps_torch import register as reg
from sps_torch.config import Config
from sps_torch.models.spsnet import SPSModel, build_levels_from_grid
from sps_torch.ops import atlas as atl
from sps_torch.ops import brick as bk
from sps_torch.ops import voxelize as vox
from sps_torch.structs import resolve_device
from sps_torch.utils import metrics as met


def build_map_atlas(map_points: np.ndarray, voxel_size: float, brick_side: int,
                    capacity: int | None = None, device=None) -> atl.AtlasGrid:
    """Resident map: a dense AABB brick grid of the map (the window extent
    is computed on the host from the map's bounding box)."""
    dev = resolve_device(device)
    m = len(map_points)
    if capacity is None:
        capacity = vox.next_pow2(max(2 * m // (brick_side * brick_side), 1024))
    shift = int(np.log2(brick_side))
    bc_min = np.floor(map_points.min(axis=0) / voxel_size).astype(np.int64) >> shift
    bc_max = np.floor(map_points.max(axis=0) / voxel_size).astype(np.int64) >> shift
    extent = (1,) + tuple(int(x) for x in (bc_max - bc_min + 2))
    pts = torch.as_tensor(np.asarray(map_points, np.float32), device=dev)
    zeros = torch.zeros(m, dtype=torch.int32, device=dev)
    grid, _ = atl.voxelize_bricks(
        vox.quantize(pts, voxel_size), zeros, zeros,
        torch.ones(m, dtype=torch.bool, device=dev),
        num_time=1, brick_capacity=capacity, brick_side=brick_side, extent=extent,
    )
    return grid


class StreamingFilter:
    """Resident map + model; one call scores one scan (n, 3) or a batch
    (NB, n, 3). Runs on the card unless device="cpu" is passed."""

    def __init__(self, cfg: Config, state_dict: dict, map_points: np.ndarray,
                 batch: int = 1, device=None):
        self.device = resolve_device(device)
        if cfg.tpu.engine != "atlas":
            raise NotImplementedError("the port's streaming filter runs the atlas engine")
        self.cfg = cfg
        self.sps_cfg = cfg.sps_config(batch_size=batch)
        self.model = SPSModel(self.sps_cfg)
        self.model.load_state_dict(state_dict, strict=True)
        self.model.to(self.device).eval()
        self.topo_every = cfg.tpu.topo_every
        self._topo_cache = None
        self._dispatch_i = 0
        map_points = np.asarray(map_points)[:, :3]
        self.map_grid = build_map_atlas(map_points, cfg.voxel_size, cfg.tpu.brick_side,
                                        device=self.device)
        # Distance-to-map input feature: one registration LUT gather per point.
        self.map_vm = (reg.build_voxel_map(map_points, 4 * cfg.voxel_size, device=self.device)
                       if self.sps_cfg.dist_feature else None)
        self.eps = cfg.threshold

    def _posed(self, scan_xyz, valid, poses):
        """Map-frame points -> (valid, voxel coords, batch index, distance to
        the map or None), flattened over the batch."""
        nb, n = scan_xyz.shape[:2]
        xyz = torch.einsum("bij,bnj->bni", poses[:, :3, :3], scan_xyz) + poses[:, None, :3, 3]
        xyz = xyz.reshape(nb * n, 3)
        vflat = valid.reshape(nb * n)
        coords = vox.quantize(xyz, self.cfg.voxel_size)
        batch_idx = torch.arange(nb, dtype=torch.int32, device=self.device).repeat_interleave(n)
        pdist = None
        if self.map_vm is not None:
            # Online semantics: capped at cfg.dist_cap (offline training uses 1.0).
            pdist = reg.point_map_distance(self.map_vm, xyz, vflat, cap=self.sps_cfg.dist_cap)
        return vflat, coords, batch_idx, pdist

    def _stats(self, scores, labels, vflat, keep, occ, overlap, overflow, miss):
        labels = labels.reshape(-1)
        return {
            "loss": met.masked_mse(scores, labels, vflat),
            "r2": met.masked_r2(scores, labels, vflat),
            **met.classification_metrics(scores, labels, vflat, self.eps),
            "n_scan_voxels": occ[..., 1].sum(dtype=torch.float32).to(torch.int32),
            "n_submap_voxels": overlap.sum(dtype=torch.float32).to(torch.int32),
            "n_kept": keep.sum(dtype=torch.int32),
            "overflow": overflow,
            "topo_miss_points": miss.sum(dtype=torch.int32),
        }

    def _rebuild(self, scan_xyz, valid, labels, poses):
        """Full program: voxelize, overlap, build the pyramid, score. Also
        returns the (levels, map-occupancy) cache for the reuse program."""
        scfg = self.sps_cfg
        bcap = scfg.caps.bricks[0]
        nb, n = scan_xyz.shape[:2]
        vflat, coords, batch_idx, pdist = self._posed(scan_xyz, valid, poses)
        ones = torch.ones(nb * n, dtype=torch.int32, device=self.device)  # scan slot 1
        grid, p2s = atl.voxelize_bricks(
            coords, batch_idx, ones, vflat, num_time=2, brick_capacity=bcap,
            brick_side=scfg.brick_side, extent=scfg.atlas_extent,
        )
        # Overlap "prune": one dense map-atlas gather per scan brick (the map
        # atlas has a single batch slot -> query batch 0).
        bvalid = torch.arange(bcap, device=self.device) < grid.num_bricks
        batch0 = torch.where(bvalid, 0, -1)
        mrow = atl.atlas_rows(self.map_grid, batch0, grid.coords[:, 1:])
        mocc = bk.take_rows(self.map_grid.occ, mrow)[..., 0]
        overlap = grid.occ[..., 1] * mocc
        occ = torch.stack([overlap, grid.occ[..., 1]], dim=-1)
        levels, lvl_overflow = build_levels_from_grid(grid._replace(occ=occ), scfg)
        with record_function("sps.model"):
            scores, aux = self.model(levels=levels, p2v=p2s, t_idx=ones, valid=vflat,
                                     point_dist=pdist)
        keep = (scores <= self.eps) & vflat
        stats = self._stats(scores, labels, vflat, keep, occ, overlap,
                            aux["overflow"].any() | lvl_overflow.any(),
                            torch.zeros_like(vflat))
        return scores.reshape(nb, n), keep.reshape(nb, n), stats, (levels, mocc)

    def _reuse(self, levels, mocc, scan_xyz, valid, labels, poses):
        """Cached-topology program: one atlas gather per point plus the
        occupancy scatter and refresh_occupancy, in place of the rebuild."""
        scfg = self.sps_cfg
        bcap = scfg.caps.bricks[0]
        bs = scfg.brick_side
        shift = bs.bit_length() - 1
        bvol = bs**3
        nb, n = scan_xyz.shape[:2]
        vflat, coords, batch_idx, pdist = self._posed(scan_xyz, valid, poses)
        l0 = levels[0].grid
        local = coords & (bs - 1)
        p2b = atl.atlas_rows(l0, batch_idx, coords >> shift)
        p2b = torch.where(vflat, p2b, vox.EMPTY)
        miss = vflat & (p2b < 0)
        lflat = (local[:, 0] * bs + local[:, 1]) * bs + local[:, 2]
        point2slot = torch.where(p2b >= 0, p2b * bvol + lflat, vox.EMPTY)
        pb = torch.where(p2b >= 0, p2b, bcap).long()
        occ1 = torch.zeros((bcap + 1) * bvol, dtype=torch.float32, device=self.device)
        # Every point with a row is valid; index_fill_ keeps the host unsynced.
        occ1.index_fill_(0, pb * bvol + lflat.long(), 1.0)
        occ1 = occ1[: bcap * bvol].reshape(bcap, bs, bs, bs).to(l0.occ.dtype)
        overlap = occ1 * mocc
        occ = torch.stack([overlap, occ1], dim=-1)
        levels2 = atl.refresh_occupancy(levels, occ)
        ones = torch.ones(nb * n, dtype=torch.int32, device=self.device)
        with record_function("sps.model"):
            scores, aux = self.model(levels=levels2, p2v=point2slot, t_idx=ones, valid=vflat,
                                     point_dist=pdist)
        keep = (scores <= self.eps) & vflat
        stats = self._stats(scores, labels, vflat, keep, occ, overlap,
                            aux["overflow"].any(), miss)
        return scores.reshape(nb, n), keep.reshape(nb, n), stats

    def __call__(self, scan_xyz, valid, labels, pose):
        """Score one scan (n, 3) or a batch (NB, n, 3); returns (scores, keep,
        stats) as device tensors (stats: dict of 0-d tensors)."""
        dev = self.device
        x = torch.as_tensor(scan_xyz, dtype=torch.float32, device=dev)
        v = torch.as_tensor(valid, dtype=torch.bool, device=dev)
        lab = torch.as_tensor(labels, dtype=torch.float32, device=dev)
        p = torch.as_tensor(pose, dtype=torch.float32, device=dev)
        squeeze = x.dim() == 2
        if squeeze:
            x, v, lab, p = x[None], v[None], lab[None], p[None]
        with torch.inference_mode():
            reuse = (
                self.topo_every > 0
                and self._topo_cache is not None
                and self._dispatch_i % self.topo_every != 0
            )
            self._dispatch_i += 1
            if reuse:
                with record_function("sps.reuse"):
                    scores, keep, stats = self._reuse(*self._topo_cache, x, v, lab, p)
            else:
                with record_function("sps.rebuild"):
                    scores, keep, stats, cache = self._rebuild(x, v, lab, p)
                if self.topo_every > 0:
                    self._topo_cache = cache
        if squeeze:
            scores, keep = scores[0], keep[0]
        return scores, keep, stats

    def invalidate(self):
        """Force the next dispatch to rebuild the topology."""
        self._topo_cache = None
        self._dispatch_i = 0
