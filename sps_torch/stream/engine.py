"""Streaming per-scan filter engine (counterpart of sps_tpu/stream/engine.py).

Per scan: pose the scan into the map frame; voxelize with T=2 time slots;
set the map-overlap bit from the resident map; build (or refresh) the
topology pyramid; MinkUNet stability scores devoxelized to points;
loss/R2/dIoU stats against the labels; keep points with score <= eps.

The engine (cfg.tpu.engine) picks the resident map and the program:
"atlas" a dense brick atlas of the map (one gather per scan brick), "brick"
a hash-table brick grid of the map (one lookup per scan brick), "gather"
(any other name) a hash table of the map's voxels (one lookup per scan
voxel). Batches of more than one scan run on the atlas engine only.

Topology reuse (TOPO_EVERY, atlas engine only): every `topo_every`-th
dispatch rebuilds the pyramid and caches it; the dispatches in between
refresh the cached pyramid's occupancy instead. Points whose brick the
cache does not cover score sigmoid(0) = 0.5 and are counted in
stats["topo_miss_points"].

With `mesh` (parallel/mesh.py, an "sp" axis) each scan runs spatially
sharded (parallel/spatial.py): every rank of the axis calls the filter with
the same inputs, builds the topology replicated, computes its block of
every conv and returns the same scores; topology reuse is off, as in
sps_tpu.

Everything per scan stays on the device: capacities are static, overflow
is data. On the atlas engine no value is read back to the host; the hash
engines' probe loops test for pending rows on the host (ops/hash.py). Profiler ranges
("sps.rebuild" / "sps.reuse", "sps.model", and per-stage ranges inside
MinkUNet) label the work in a torch.profiler trace; without a profiler
they cost a few microseconds per scan.

The rebuild program is three methods, one per stage, which
sps_torch/scripts/profile_stream.py times one by one: `stage_vox` (pose,
voxelize, map overlap), `stage_topo` (the pyramid) and `stage_unet`
(MinkUNet, devoxelize, sigmoid), each under a range "sps.stage.vox" /
"sps.stage.topo" / "sps.stage.unet".
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from sps_torch import register as reg
from sps_torch.config import Config
from sps_torch.models.spsnet import SPSModel, build_levels_from_grid
from sps_torch.ops import atlas as atl
from sps_torch.ops import brick as bk
from sps_torch.ops import hash as vhash
from sps_torch.ops import voxelize as vox
from sps_torch.parallel import spatial as sp_mod
from sps_torch.structs import resolve_device
from sps_torch.utils import metrics as met
from sps_torch.utils.geometry import transform_points


class Voxelized(NamedTuple):
    """Stage 1's output: the stride-1 grid (occupancy [map bit, scan]), the
    point-to-slot map and the per-point inputs of stage 3, flattened over
    the batch; the counts for the stats; the atlas engine's map occupancy
    per scan brick (None on the hash engines)."""

    grid: object
    p2v: torch.Tensor
    t_idx: torch.Tensor
    valid: torch.Tensor
    dist: torch.Tensor | None
    n_scan: torch.Tensor
    overlap: torch.Tensor
    mocc: torch.Tensor | None


def _count(occ):
    return occ.sum(dtype=torch.float32).to(torch.int32)


def _map_points(map_points, device):
    m = len(map_points)
    pts = torch.as_tensor(np.asarray(map_points, np.float32), device=device)
    zeros = torch.zeros(m, dtype=torch.int32, device=device)
    return pts, zeros, torch.ones(m, dtype=torch.bool, device=device)


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
    pts, zeros, ones = _map_points(map_points, dev)
    grid, _ = atl.voxelize_bricks(vox.quantize(pts, voxel_size), zeros, zeros, ones, num_time=1,
                                  brick_capacity=capacity, brick_side=brick_side, extent=extent)
    return grid


def build_map_table(map_points: np.ndarray, voxel_size: float, capacity: int | None = None,
                    device=None):
    """Resident map of the gather engine: the hash table of the map's
    voxels, and their count (a device scalar)."""
    dev = resolve_device(device)
    if capacity is None:
        capacity = vox.next_pow2(len(map_points))
    pts, zeros, ones = _map_points(map_points, dev)
    grid, _, _ = vox.voxelize(vox.quantize(pts, voxel_size), zeros, zeros, ones, num_time=1,
                              voxel_capacity=capacity)
    return grid.table, grid.num_voxels


def build_map_bricks(map_points: np.ndarray, voxel_size: float, capacity: int | None = None,
                     brick_side: int = 4, device=None) -> bk.BrickGrid:
    """Resident map of the brick engine: a hash-table brick grid of the map
    whose per-voxel occupancy answers the overlap query with one brick
    lookup per scan brick."""
    dev = resolve_device(device)
    m = len(map_points)
    if capacity is None:
        # LiDAR maps are surface-like: occupied bricks scale ~ m / side^2.
        capacity = vox.next_pow2(max(2 * m // (brick_side * brick_side), 1024))
    pts, zeros, ones = _map_points(map_points, dev)
    grid, _ = bk.voxelize_bricks(vox.quantize(pts, voxel_size), zeros, zeros, ones, num_time=1,
                                 brick_capacity=capacity, brick_side=brick_side)
    return grid


class StreamingFilter:
    """Resident map + model; one call scores one scan (n, 3) or, on the
    atlas engine, a batch (NB, n, 3). Runs on the card unless device="cpu"
    is passed. mesh: spread each scan's brick / row axis over the mesh's
    `sp_axis` ranks, with the ghost exchange when sp_ghost_frac > 0."""

    def __init__(self, cfg: Config, state_dict: dict, map_points: np.ndarray,
                 batch: int = 1, device=None, mesh=None, sp_axis: str = "sp",
                 sp_ghost_frac: float = 0.0):
        self.device = resolve_device(device)
        self.engine = cfg.tpu.engine
        if self.engine != "atlas" and batch != 1:
            raise ValueError("batches of more than one scan run on the atlas engine only")
        self.cfg = cfg
        self.sps_cfg = cfg.sps_config(batch_size=batch)
        if mesh is not None:
            if sp_axis not in mesh.axis_names:
                raise ValueError(f"the mesh has no {sp_axis!r} axis: {mesh.axis_names}")
            if self.sps_cfg.dist_feature:
                raise ValueError("dist_feature under spatial sharding is not implemented")
            self.sps_cfg = sp_mod.sp_config(self.sps_cfg, sp_axis, ghost_frac=sp_ghost_frac)
        self.model = SPSModel(self.sps_cfg)
        self.model.load_state_dict(state_dict, strict=True)
        self.model.to(self.device).eval()
        self.topo_every = cfg.tpu.topo_every if self.engine == "atlas" and mesh is None else 0
        self._topo_cache = None
        self._dispatch_i = 0
        map_points = np.asarray(map_points)[:, :3]
        if self.engine == "atlas":
            self.map_grid = build_map_atlas(map_points, cfg.voxel_size, cfg.tpu.brick_side,
                                            device=self.device)
        elif self.engine == "brick":
            self.map_grid = build_map_bricks(map_points, cfg.voxel_size,
                                             brick_side=cfg.tpu.brick_side, device=self.device)
        else:
            self.map_table, self.map_voxels = build_map_table(map_points, cfg.voxel_size,
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

    def _stats(self, scores, labels, vflat, keep, n_scan, overlap, overflow, miss=None):
        """The engine's stats: the atlas engine's also count topology misses."""
        labels = labels.reshape(-1)
        stats = {
            "loss": met.masked_mse(scores, labels, vflat),
            "r2": met.masked_r2(scores, labels, vflat),
            **met.classification_metrics(scores, labels, vflat, self.eps),
            "n_scan_voxels": n_scan,
            "n_submap_voxels": _count(overlap),
            "n_kept": keep.sum(dtype=torch.int32),
            "overflow": overflow,
        }
        if miss is not None:
            stats["topo_miss_points"] = miss.sum(dtype=torch.int32)
        return stats

    def stage_vox(self, scan_xyz, valid, poses) -> Voxelized:
        """Stage 1 of the rebuild program: pose the scans (NB, n, 3) into the
        map frame, voxelize them into the scan slot and set the map bit where
        the map holds the voxel: one dense atlas gather per scan brick
        (atlas), one map lookup per scan brick (brick) or voxel (gather)."""
        with record_function("sps.stage.vox"):
            if self.engine == "atlas":
                return self._vox_atlas(scan_xyz, valid, poses)
            return self._vox_hash(scan_xyz, valid, poses)

    def stage_topo(self, grid):
        """Stage 2: the topology pyramid of the stage-1 grid, (levels,
        per-level overflow)."""
        with record_function("sps.stage.topo"):
            return build_levels_from_grid(grid, self.sps_cfg)

    def stage_unet(self, levels, vx: Voxelized):
        """Stage 3: MinkUNet on the pyramid, devoxelized to the points, the
        sigmoid: (scores (NB * n,), aux). "sps.model" spans the same work as
        "sps.stage.unet": it is the name the reuse program's model call and
        the loop's profiles read."""
        with record_function("sps.stage.unet"), record_function("sps.model"):
            return self.model(levels=levels, p2v=vx.p2v, t_idx=vx.t_idx, valid=vx.valid,
                              point_dist=vx.dist)

    def _vox_atlas(self, scan_xyz, valid, poses) -> Voxelized:
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
        scan_occ = grid.occ[..., 1]
        overlap = scan_occ * mocc
        grid = grid._replace(occ=torch.stack([overlap, scan_occ], dim=-1))
        return Voxelized(grid, p2s, ones, vflat, pdist, _count(scan_occ), overlap, mocc)

    def _vox_hash(self, scan_xyz, valid, poses) -> Voxelized:
        """The gather and brick engines' stage 1, one scan (NB = 1)."""
        if scan_xyz.shape[0] != 1:
            raise ValueError("batches of more than one scan run on the atlas engine only")
        scfg = self.sps_cfg
        x, v = scan_xyz[0], valid[0]
        n = x.shape[0]
        xyz = transform_points(x, poses[0])
        pdist = None
        if self.map_vm is not None:
            pdist = reg.point_map_distance(self.map_vm, xyz, v, cap=scfg.dist_cap)
        coords = vox.quantize(xyz, self.cfg.voxel_size)
        zeros = torch.zeros(n, dtype=torch.int32, device=self.device)
        ones = torch.ones(n, dtype=torch.int32, device=self.device)  # scan slot 1
        if self.engine == "brick":
            bcap = scfg.caps.bricks[0]
            grid, p2v = bk.voxelize_bricks(coords, zeros, ones, v, num_time=2,
                                           brick_capacity=bcap, brick_side=scfg.brick_side)
            bvalid = torch.arange(bcap, device=self.device) < grid.num_bricks
            mrow = vhash.lookup(self.map_grid.table, grid.coords, bvalid)
            scan_occ = grid.occ[..., 1]
            overlap = scan_occ * bk.take_rows(self.map_grid.occ, mrow)[..., 0]
            n_scan = _count(scan_occ)
        else:
            vcap = scfg.caps.voxels[0]
            grid, p2v, _ = vox.voxelize(coords, zeros, ones, v, num_time=2,
                                        voxel_capacity=vcap)
            rows_valid = torch.arange(vcap, device=self.device) < grid.num_voxels
            hit = vhash.lookup(self.map_table, grid.coords, rows_valid) >= 0
            overlap = (hit & rows_valid).to(grid.occ.dtype)
            scan_occ = grid.occ[:, 1]
            n_scan = grid.num_voxels
        grid = grid._replace(occ=torch.stack([overlap, scan_occ], dim=-1))
        return Voxelized(grid, p2v, ones, v, pdist, n_scan, overlap, None)

    def _rebuild(self, scan_xyz, valid, labels, poses):
        """Full program, the three stages in turn. Returns (scores, keep,
        stats, cache): the atlas engine's (levels, map-occupancy) cache for
        the reuse program, None on the hash engines."""
        vx = self.stage_vox(scan_xyz, valid, poses)
        levels, lvl_overflow = self.stage_topo(vx.grid)
        scores, aux = self.stage_unet(levels, vx)
        keep = (scores <= self.eps) & vx.valid
        atlas = self.engine == "atlas"
        stats = self._stats(scores, labels, vx.valid, keep, vx.n_scan, vx.overlap,
                            aux["overflow"].any() | lvl_overflow.any(),
                            torch.zeros_like(vx.valid) if atlas else None)
        nb = scan_xyz.shape[0]
        cache = (levels, vx.mocc) if atlas else None
        return scores.reshape(nb, -1), keep.reshape(nb, -1), stats, cache

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
        stats = self._stats(scores, labels, vflat, keep, _count(occ[..., 1]), overlap,
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
