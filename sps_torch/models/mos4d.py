"""MOS4D: moving-object segmentation over a buffer of N scans
(counterpart of sps_tpu/models/mos4d.py).

A MinkUNet14 (in=1, out=3, D=4) over the merged cloud of the last N scans,
the scan's index in the buffer as its time slot (num_time = N). The input
feature is 0.5 on occupied slots; the per-point moving logit is channel 2,
0 for padded points. As in sps_tpu, the input feature keeps the occupancy's
bf16, and the network computes in the dtype of its input: MOS4D runs in
bf16 (parameters stay f32).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from sps_torch.models.minkunet import MinkUNet, MinkUNetConfig
from sps_torch.models.spsnet import SPSConfig, build_pyramid
from sps_torch.ops import voxelize as vox
from sps_torch.structs import Capacities, PointBatch


@dataclasses.dataclass(frozen=True)
class MOS4DConfig:
    voxel_size: float = 0.1
    n_scans: int = 10  # buffer length (the reference parses it from the ckpt name)
    caps: Capacities = Capacities()
    engine: str = "atlas"
    brick_side: int = 8
    atlas_extent: tuple = (1, 96, 96, 24)
    row_from: int | None = 3

    def sps_config(self) -> SPSConfig:
        return SPSConfig(
            voxel_size=self.voxel_size, caps=self.caps,
            unet=MinkUNetConfig(in_channels=1, out_channels=3, num_time=self.n_scans,
                                conv_mode="halo"),
            engine=self.engine, brick_side=self.brick_side,
            atlas_extent=self.atlas_extent, row_from=self.row_from,
        )


class MOS4DNet(nn.Module):
    def __init__(self, cfg: MOS4DConfig, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.MinkUNet = MinkUNet(cfg.sps_config().unet, generator)

    def forward(self, pb: PointBatch):
        """pb.t holds the buffer index in [0, n_scans). Returns ((N,) moving
        logits, {"overflow": per-level flags})."""
        scfg = self.cfg.sps_config()
        levels, p2s, overflow = build_pyramid(pb, scfg)
        feats0 = 0.5 * levels[0].grid.occ  # bf16, as sps_tpu's
        out = self.MinkUNet(feats0, levels)
        per_point = vox.devoxelize_flat(out, p2s, pb.t, num_time=self.cfg.n_scans,
                                        channels=3).float()
        return per_point[:, 2] * pb.valid.float(), {"overflow": overflow}
