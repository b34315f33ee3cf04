"""Typed configuration from the repo's YAML schema (counterpart of sps_tpu/config.py).

Reads the same files as sps_tpu (config/*.yaml, the reference schema plus
a `TPU:` section of static capacities and engine options) and builds the
port's own SPSConfig / MinkUNetConfig.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import yaml

from sps_torch.models.minkunet import MinkUNetConfig
from sps_torch.models.spsnet import SPSConfig
from sps_torch.structs import Capacities


@dataclasses.dataclass(frozen=True)
class DataConfig:
    root: str = ""
    train: tuple = ()
    val: tuple = ()
    test: tuple = ()
    map_file: str = "base_map.asc.npy"
    shuffle: bool = True


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    max_epoch: int = 80
    lr: float = 7e-5
    lr_epoch: int = 1
    lr_decay: float = 0.99
    weight_decay: float = 1e-4
    batch_size: int = 2
    augmentation: bool = True
    stable_weight: float = 1.0
    loss: str = "mse"


@dataclasses.dataclass(frozen=True)
class TPUConfig:
    """Static shape budget and engine options (the YAML's `TPU:` section;
    per sample unless noted)."""

    scan_points: int = 1 << 17
    submap_points: int = 1 << 17
    cell_capacity: int = 1 << 18
    voxels: tuple = (1 << 18, 1 << 16, 1 << 14, 1 << 12, 1 << 10)  # whole batch
    bricks: tuple = (1 << 15, 1 << 14, 1 << 13, 1 << 12, 1 << 11)  # whole batch
    engine: str = "brick"
    brick_side: int = 4
    atlas_extent: tuple = (256, 256, 96)
    conv_mode: str = "region"
    zband_levels: int = 1
    row_from: int = 0
    max_per_cell: int = 8
    join_mode: str = "hash"
    join_extent: tuple = (640, 640, 128)
    bf16: bool = False
    remat: bool = False
    int8: bool = False
    stem_zband: bool = False
    head_fold: bool = False
    # Streaming topology reuse: rebuild the pyramid every N scans (0 disables).
    topo_every: int = 0


@dataclasses.dataclass(frozen=True)
class Config:
    experiment_id: str = "BLT"
    data: DataConfig = DataConfig()
    train: TrainConfig = TrainConfig()
    voxel_size: float = 0.1
    threshold: float = 0.84
    tpu: TPUConfig = TPUConfig()
    dist_feature: bool = False
    dist_cap: float = 1.0

    @property
    def point_capacity(self) -> int:
        return self.train.batch_size * (self.tpu.scan_points + self.tpu.submap_points)

    def sps_config(self, batch_size: int | None = None) -> SPSConfig:
        """Model config at a batch size: the YAML's voxel/brick capacities are
        budgeted for the training batch and scale down (rounded up to 128,
        at least 256) for smaller batches; streaming uses 1."""
        bs = batch_size if batch_size is not None else self.train.batch_size

        def rup(x):
            return max(256, (x + 127) // 128 * 128)

        factor = bs / max(self.train.batch_size, 1)
        caps = Capacities(
            points=bs * (self.tpu.scan_points + self.tpu.submap_points),
            voxels=tuple(rup(int(v * factor)) for v in self.tpu.voxels),
            bricks=tuple(rup(int(v * factor)) for v in self.tpu.bricks),
        )
        return SPSConfig(
            voxel_size=self.voxel_size,
            threshold=self.threshold,
            caps=caps,
            unet=MinkUNetConfig(
                in_channels=2 if self.dist_feature else 1,
                out_channels=1,
                num_time=2,
                dtype=torch.bfloat16 if self.tpu.bf16 else torch.float32,
                conv_mode=self.tpu.conv_mode,
                zband_levels=self.tpu.zband_levels,
                int8=self.tpu.int8,
                stem_zband=self.tpu.stem_zband,
                remat=self.tpu.remat,
                head_fold=self.tpu.head_fold,
            ),
            engine=self.tpu.engine,
            brick_side=self.tpu.brick_side,
            atlas_extent=(bs,) + tuple(self.tpu.atlas_extent),
            row_from=self.tpu.row_from if self.tpu.row_from > 0 else None,
            dist_feature=self.dist_feature,
            dist_cap=self.dist_cap,
        )


def load(path: str, data_root: str | None = None) -> Config:
    """Load a reference-schema YAML config file."""
    with open(path) as f:
        y = yaml.safe_load(f)
    split = y.get("DATA", {}).get("SPLIT", {})
    tr = y.get("TRAIN", {})
    tpu = y.get("TPU", {})
    model = y.get("MODEL", {})
    root = data_root or os.environ.get("DATA", "")
    d = TPUConfig
    return Config(
        experiment_id=y.get("EXPERIMENT", {}).get("ID", "BLT"),
        data=DataConfig(
            root=root,
            train=tuple(split.get("TRAIN", []) or []),
            val=tuple(split.get("VAL", []) or []),
            test=tuple(split.get("TEST", []) or []),
            map_file=tr.get("MAP", "base_map.asc.npy"),
            shuffle=bool(y.get("DATA", {}).get("SHUFFLE", True)),
        ),
        train=TrainConfig(
            max_epoch=int(tr.get("MAX_EPOCH", 80)),
            lr=float(tr.get("LR", 7e-5)),
            lr_epoch=int(tr.get("LR_EPOCH", 1)),
            lr_decay=float(tr.get("LR_DECAY", 0.99)),
            weight_decay=float(tr.get("WEIGHT_DECAY", 1e-4)),
            batch_size=int(tr.get("BATCH_SIZE", 2)),
            augmentation=bool(tr.get("AUGMENTATION", True)),
            stable_weight=float(tr.get("STABLE_WEIGHT", 1.0)),
            loss=str(tr.get("LOSS", "mse")).lower(),
        ),
        voxel_size=float(model.get("VOXEL_SIZE", 0.1)),
        threshold=float(y.get("FILTER", {}).get("THRESHOLD", 0.84)),
        dist_feature=bool(model.get("DIST_FEATURE", False)),
        dist_cap=float(model.get("DIST_CAP", 1.0)),
        tpu=TPUConfig(
            scan_points=int(tpu.get("SCAN_POINTS", d.scan_points)),
            submap_points=int(tpu.get("SUBMAP_POINTS", d.submap_points)),
            cell_capacity=int(tpu.get("CELL_CAPACITY", d.cell_capacity)),
            voxels=tuple(tpu.get("VOXELS", d.voxels)),
            bricks=tuple(tpu.get("BRICKS", d.bricks)),
            engine=str(tpu.get("ENGINE", d.engine)),
            brick_side=int(tpu.get("BRICK_SIDE", d.brick_side)),
            atlas_extent=tuple(tpu.get("ATLAS_EXTENT", d.atlas_extent)),
            conv_mode=str(tpu.get("CONV_MODE", d.conv_mode)),
            zband_levels=int(tpu.get("ZBAND_LEVELS", d.zband_levels)),
            row_from=int(tpu.get("ROW_FROM", d.row_from)),
            max_per_cell=int(tpu.get("MAX_PER_CELL", d.max_per_cell)),
            join_mode=str(tpu.get("JOIN_MODE", d.join_mode)),
            join_extent=tuple(tpu.get("JOIN_EXTENT", d.join_extent)),
            bf16=bool(tpu.get("BF16", False)),
            remat=bool(tpu.get("REMAT", False)),
            int8=bool(tpu.get("INT8", False)),
            topo_every=int(tpu.get("TOPO_EVERY", 0)),
            stem_zband=bool(tpu.get("STEM_ZBAND", False)),
            head_fold=bool(tpu.get("HEAD_FOLD", False)),
        ),
    )
