"""SPS stability-scoring model (counterpart of sps_tpu/models/spsnet.py).

Points -> per-point stability in [0, 1]: voxelize, build the topology
pyramid, MinkUNet(in=1, out=1, D=4) on the constant 0.5 input feature,
devoxelize, sigmoid. The engine is static config, as in sps_tpu: "atlas"
(bricks with the dense-AABB topology of ops/atlas.py), "brick" (bricks with
the hash topology of ops/brick.py) or "gather" (voxel rows with the hash
topology of ops/topology.py); the parameters are the same under every
engine. Three entry modes: a PointBatch (the offline path: the model calls
build_pyramid), a stride-1 grid with p2v (the gather and brick streaming
programs), or a prebuilt pyramid with levels/p2v (the atlas streaming
programs).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from sps_torch.models.minkunet import MaskedBatchNorm, MinkUNet, MinkUNetConfig
from sps_torch.ops import atlas as atl
from sps_torch.ops import brick as bk
from sps_torch.ops import topology as topo
from sps_torch.ops import voxelize as vox
from sps_torch.parallel import comm
from sps_torch.parallel import spatial as sp_mod
from sps_torch.structs import Capacities, PointBatch

NUM_LEVELS = 5
MAP_T = 0  # the map's time slot (the scan's is 1)


@dataclasses.dataclass(frozen=True)
class SPSConfig:
    voxel_size: float = 0.1
    threshold: float = 0.84
    caps: Capacities = Capacities()
    unet: MinkUNetConfig = MinkUNetConfig(in_channels=1, out_channels=1, num_time=2)
    # The defaults are sps_tpu's. "atlas", "brick" or "gather" (any other
    # name is the gather engine, as in sps_tpu).
    engine: str = "brick"
    brick_side: int = 4
    # Static atlas window (NB, NX, NY, NZ) in bricks.
    atlas_extent: tuple = (2, 256, 256, 96)
    # Atlas engine: levels >= row_from run as voxel rows (None: all bricks),
    # aliased to brick level li-3 with side 8 and row_from >= 3, else built
    # by atlas.hybridize_levels with row capacities caps.voxels.
    row_from: int | None = None
    dist_feature: bool = False
    dist_cap: float = 1.0


def build_levels_from_grid(grid, cfg: SPSConfig):
    """Topology pyramid from a stride-1 grid of any engine: an AtlasGrid
    gives brick levels [0, row_from) plus row levels (aliased with side 8
    and row_from >= 3: the deep brick levels are never built; hybridized
    otherwise) or, with row_from None, five brick levels; a BrickGrid five
    brick levels, a VoxelGrid five voxel-row levels. Returns (levels,
    overflow)."""
    if isinstance(grid, atl.AtlasGrid):
        if cfg.row_from is not None and cfg.row_from >= 3 and cfg.brick_side == 8:
            # Side-8 identity: level-(k+3) voxels are level-k bricks.
            levels = atl.build_levels(grid, num_levels=cfg.row_from, capacities=cfg.caps.bricks)
            levels = atl.alias_row_levels(levels, NUM_LEVELS)
        else:
            levels = atl.build_levels(grid, num_levels=NUM_LEVELS, capacities=cfg.caps.bricks)
            if cfg.row_from is not None:
                levels = atl.hybridize_levels(levels, cfg.row_from, cfg.caps.voxels)
    elif isinstance(grid, bk.BrickGrid):
        levels = bk.build_brick_levels(grid, num_levels=NUM_LEVELS, capacities=cfg.caps.bricks)
    else:
        u = cfg.unet
        ks = ((u.first_kernel, u.block_kernel),) + ((u.block_kernel,),) * (NUM_LEVELS - 1)
        levels = topo.build_levels(grid, num_levels=NUM_LEVELS, capacities=cfg.caps.voxels,
                                   kernel_sizes=ks)
    overflow = torch.stack([lv.grid.overflow for lv in levels])
    return levels, overflow


def voxelize_points(coords, batch_idx, t_idx, valid, cfg: SPSConfig, features=None):
    """The engine's stride-1 grid of (N, 3) voxel coords: (grid, point2slot)
    plus the pooled features when `features` is given. point2slot indexes
    the flat (rows, T, C) view of level 0 (rows = V for the gather engine,
    B * bs^3 for the brick engines)."""
    t, c = cfg.unet.num_time, cfg.caps
    if cfg.engine == "atlas":
        return atl.voxelize_bricks(coords, batch_idx, t_idx, valid, num_time=t,
                                   brick_capacity=c.bricks[0], brick_side=cfg.brick_side,
                                   extent=cfg.atlas_extent, features=features)
    if cfg.engine == "brick":
        return bk.voxelize_bricks(coords, batch_idx, t_idx, valid, num_time=t,
                                  brick_capacity=c.bricks[0], brick_side=cfg.brick_side,
                                  features=features)
    grid, p2v, pooled = vox.voxelize(coords, batch_idx, t_idx, valid, num_time=t,
                                     voxel_capacity=c.voxels[0], features=features)
    if features is None:
        return grid, p2v
    return grid, p2v, pooled.reshape(pooled.shape[0], -1)


def build_pyramid(pb: PointBatch, cfg: SPSConfig):
    """Voxelize a point batch and build the pyramid: (levels, point2slot, overflow)."""
    grid, p2s = voxelize_points(vox.quantize(pb.xyz, cfg.voxel_size), pb.batch, pb.t,
                                pb.valid, cfg)
    levels, overflow = build_levels_from_grid(grid, cfg)
    return levels, p2s, overflow


class SPSModel(nn.Module):
    def __init__(self, cfg: SPSConfig, generator: torch.Generator | None = None):
        super().__init__()
        if cfg.dist_feature and cfg.unet.in_channels != 2:
            raise ValueError("dist_feature needs in_channels=2")
        if cfg.dist_feature and cfg.unet.sp_axis is not None:
            raise ValueError("dist_feature under spatial sharding needs a sliced scatter; "
                             "not implemented (as in sps_tpu)")
        self.cfg = cfg
        self.MinkUNet = MinkUNet(cfg.unet, generator)

    def forward(self, pb: PointBatch | None = None, *, levels=None, p2v=None,
                t_idx=None, valid=None, point_dist=None):
        """Returns (scores, aux): (N,) sigmoid stability scores (0 for padded
        points) and a dict with the per-level overflow flags. With `pb` the
        model voxelizes the batch itself (t_idx, valid and point_dist from
        it); otherwise levels give a prebuilt pyramid (build_levels_from_grid
        of a stride-1 grid whose occupancy already holds the map bit), and
        p2v/t_idx/valid go with them.
        point_dist: (N,) distance to the map per point (the dist_feature
        input; 0 when None). Under spatial sharding (cfg.unet.sp_axis) the
        replicated pyramid is sliced to this rank's blocks, and the UNet's
        output is all-gathered before devoxelizing: every rank returns the
        same scores, and the flags include ghost overflow."""
        cfg = self.cfg
        if pb is not None:
            levels, p2v, overflow = build_pyramid(pb, cfg)
            t_idx, valid = pb.t, pb.valid
            if point_dist is None:
                point_dist = pb.dist
        else:
            overflow = torch.stack([lv.grid.overflow for lv in levels])
        sp = cfg.unet.sp_axis
        if sp is not None:
            levels = sp_mod.slice_levels(levels, sp, ghost_frac=cfg.unet.sp_ghost_frac)
            # Ghost overflow is a rank's own: OR the flags over the axis so
            # that every rank reports it.
            overflow = comm.pmax(torch.stack([lv.grid.overflow for lv in levels]).to(torch.int32),
                                 sp) > 0
        occ0 = levels[0].grid.occ
        if cfg.dist_feature:
            feats0 = self._dist_feats(occ0, p2v, t_idx, valid, point_dist)
        else:
            # Constant 0.5 input feature on occupied slots.
            feats0 = (0.5 * occ0.repeat_interleave(cfg.unet.in_channels, dim=-1)).to(
                cfg.unet.dtype)
        out = self.MinkUNet(feats0, levels)
        if sp is not None:
            out = comm.all_gather(out, sp)
        per_point = vox.devoxelize_flat(
            out, p2v, t_idx, num_time=cfg.unet.num_time, channels=cfg.unet.out_channels
        )[:, 0].float()
        scores = torch.sigmoid(per_point) * valid.to(per_point.dtype)
        return scores, {"overflow": overflow, "point2voxel": p2v}

    def _dist_feats(self, occ0, p2v, t_idx, valid, point_dist):
        """Two channels per time slot: 0.5 * occupancy and the distance to
        the map, scatter-min of the points' distances into their (slot, t)
        cells (cells without a point stay at dist_cap), scaled to [0, 1],
        masked by occupancy; the MAP slot's distance is 0 by definition."""
        cfg = self.cfg
        t = cfg.unet.num_time
        st = occ0.numel()  # slots * T; the index matches devoxelize_flat
        if point_dist is None:
            point_dist = torch.zeros(t_idx.shape, dtype=torch.float32, device=occ0.device)
        idx = torch.where((p2v >= 0) & valid,
                          p2v.clamp(min=0).long() * t + t_idx.clamp(0, t - 1).long(), st)
        dvox = torch.full((st + 1,), cfg.dist_cap, dtype=torch.float32, device=occ0.device)
        dvox.scatter_reduce_(0, idx, point_dist.float(), "amin", include_self=True)
        occ = occ0.float()
        d01 = (dvox[:st].view(occ0.shape) / cfg.dist_cap) * occ
        if t >= 2:
            d01.select(-1, MAP_T).fill_(0.0)
        return torch.stack([0.5 * occ, d01], -1).reshape(
            occ0.shape[:-1] + (t * 2,)).to(cfg.unet.dtype)


def init_state_dict(cfg: SPSConfig, seed: int = 0) -> dict[str, torch.Tensor]:
    """Seeded random weights: He-normal kernels and, so that BN is not the
    identity, random running statistics (mean 0.3*N(0,1), var 0.5+U(0,1))."""
    g = torch.Generator().manual_seed(seed)
    model = SPSModel(cfg, generator=g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, MaskedBatchNorm):
                m.mean.copy_(0.3 * torch.randn(m.features, generator=g))
                m.var.copy_(0.5 + torch.rand(m.features, generator=g))
    return model.state_dict()
