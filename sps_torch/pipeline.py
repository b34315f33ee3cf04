"""Offline batch assembly: scan -> submap join -> one flat PointBatch
(counterpart of sps_tpu/pipeline.py).

Per sample: find the map points near the scan (the radius join of
JOIN_MODE: hash, the exact join, or dense),
compact them into SUBMAP_POINTS slots, and stack [scan (t = 1, its labels) ;
submap (t = 0, label 1)] into the flat padded PointBatch the model's
PointBatch entry takes; in training, augment scan and submap jointly with
one matrix per sample. Everything stays on the device of the inputs.
"""

from __future__ import annotations

import torch

from sps_torch import register as reg
from sps_torch.config import Config
from sps_torch.ops import augment as aug
from sps_torch.ops import radius as rad
from sps_torch.structs import PointBatch

SCAN_T = 1
MAP_T = 0


def assemble_batch(scan_xyz, scan_label, scan_valid, map_points, cfg: Config, rng=None,
                   map_vm=None) -> tuple[PointBatch, dict]:
    """(B, Ns, 3) map-frame scans, (B, Ns) labels and validity, (M, 3) map
    points -> (PointBatch of capacity B * (Ns + SUBMAP_POINTS), aux
    counters: submap_overflow, cell_dropped, submap_count as int32 counts).

    map_vm (a register.VoxelMap) adds each point's distance to the map,
    uncapped beyond 1.0 as offline. rng (a torch.Generator; training)
    draws one augmentation matrix per sample, applied to its scan and
    submap after the distance feature."""
    bsz, ns, _ = scan_xyz.shape
    sub = cfg.tpu.submap_points
    dev = scan_xyz.device
    map_valid = torch.ones(map_points.shape[0], dtype=torch.bool, device=dev)
    sub_xyz, sub_valid, overflow, dropped = [], [], [], []
    for b in range(bsz):
        if cfg.tpu.join_mode == "dense":
            mask, drop = rad.radius_join_dense(scan_xyz[b], scan_valid[b], map_points,
                                               map_valid, cfg.voxel_size,
                                               extent=cfg.tpu.join_extent)
        else:
            mask, drop = rad.radius_join(scan_xyz[b], scan_valid[b], map_points, map_valid,
                                         cfg.voxel_size, cell_capacity=cfg.tpu.cell_capacity,
                                         max_per_cell=cfg.tpu.max_per_cell)
        idx, sv, ovf = rad.compact_mask(mask, sub)
        sub_xyz.append(map_points[idx.long()] * sv[:, None].to(map_points.dtype))
        sub_valid.append(sv)
        overflow.append(ovf)
        dropped.append(drop)
    sub_xyz, sub_valid = torch.stack(sub_xyz), torch.stack(sub_valid)
    xyz = torch.cat([scan_xyz, sub_xyz], 1)  # (B, Ns + Sub, 3)
    valid = torch.cat([scan_valid, sub_valid], 1)
    dist = None
    if map_vm is not None:
        # Before any augmentation: the feature is the map support of the
        # original geometry. Submap points are map points (distance ~0).
        dist = torch.stack([reg.point_map_distance(map_vm, xyz[b], valid[b])
                            for b in range(bsz)])
    if rng is not None:
        mats = torch.stack([aug.augmentation_matrix(rng) for _ in range(bsz)]).to(dev)
        xyz = torch.bmm(xyz, mats)
    # Submap labels are constant 1.
    label = torch.cat([scan_label, torch.ones((bsz, sub), dtype=scan_label.dtype, device=dev)],
                      1)
    t = torch.cat([torch.full((bsz, ns), SCAN_T, dtype=torch.int32, device=dev),
                   torch.full((bsz, sub), MAP_T, dtype=torch.int32, device=dev)], 1)
    batch_idx = torch.arange(bsz, dtype=torch.int32, device=dev)[:, None].expand(bsz, ns + sub)
    flat = PointBatch(
        xyz=xyz.reshape(-1, 3),
        batch=batch_idx.reshape(-1),
        t=t.reshape(-1),
        label=label.reshape(-1),
        valid=valid.reshape(-1),
        dist=dist.reshape(-1) if dist is not None else None,
    )
    aux = {
        "submap_overflow": torch.stack(overflow).sum(dtype=torch.int32),
        "cell_dropped": torch.stack(dropped).sum(dtype=torch.int32),
        "submap_count": sub_valid.sum(dtype=torch.int32),
    }
    return flat, aux
