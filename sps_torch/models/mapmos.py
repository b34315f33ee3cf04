"""MapMOS: moving-object segmentation of a scan against a local map
(counterpart of sps_tpu/models/mapmos.py).

A MinkUNet14 (in=1, out=1, D=4) over the scan (time slot 1) and the local
map (slot 0) with normalised time-index features
  f = 1 + (i_max - i) / (i_max - i_min)   (1 when all indices are equal),
mean-pooled per voxel slot (under the atlas, brick or voxelize/gather
engine); per-point logits, label = logit > 0. The features are f32, so
the network computes in f32.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from sps_torch.models.minkunet import MinkUNet, MinkUNetConfig
from sps_torch.models.spsnet import SPSConfig, build_levels_from_grid, voxelize_points
from sps_torch.ops import voxelize as vox
from sps_torch.structs import Capacities, PointBatch


@dataclasses.dataclass(frozen=True)
class MapMOSConfig:
    voxel_size: float = 0.1
    caps: Capacities = Capacities()
    engine: str = "atlas"
    brick_side: int = 8
    atlas_extent: tuple = (1, 96, 96, 24)
    row_from: int | None = 3

    def sps_config(self) -> SPSConfig:
        return SPSConfig(
            voxel_size=self.voxel_size, caps=self.caps,
            unet=MinkUNetConfig(in_channels=1, out_channels=1, num_time=2, conv_mode="halo"),
            engine=self.engine, brick_side=self.brick_side,
            atlas_extent=self.atlas_extent, row_from=self.row_from,
        )


def normalized_index_features(indices: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(N,) scan indices -> (N, 1) features 1 + (i_max - i) / (i_max - i_min)
    over the valid points; all equal -> 1."""
    big = 1e9
    i = indices.float()
    imax = torch.where(valid, i, -big).amax()
    imin = torch.where(valid, i, big).amin()
    f = torch.where(imax <= imin, 1.0, 1.0 + (imax - i) / torch.clamp_min(imax - imin, 1e-9))
    return f[:, None]


class MapMOSNet(nn.Module):
    def __init__(self, cfg: MapMOSConfig, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.MinkUNet = MinkUNet(cfg.sps_config().unet, generator)

    def forward(self, pb: PointBatch, indices: torch.Tensor):
        """pb.t: scan 1, map 0; indices: per-point scan index. Returns ((N,)
        logits, {"overflow": per-level flags})."""
        scfg = self.cfg.sps_config()
        feats = normalized_index_features(indices, pb.valid)
        grid, p2s, pooled = voxelize_points(vox.quantize(pb.xyz, scfg.voxel_size), pb.batch,
                                            pb.t, pb.valid, scfg, features=feats)
        levels, overflow = build_levels_from_grid(grid, scfg)
        out = self.MinkUNet(pooled, levels)
        logits = vox.devoxelize_flat(out, p2s, pb.t, num_time=2, channels=1)[:, 0].float()
        return logits * pb.valid.float(), {"overflow": overflow}


def to_label(logits: torch.Tensor) -> torch.Tensor:
    return (logits > 0).float()
