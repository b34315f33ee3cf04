"""Voxel quantization and devoxelization (counterpart of sps_tpu/ops/voxelize.py).

Quantization uses floor semantics for negative coordinates too, as
MinkowskiEngine's TensorField.sparse() does. The time coordinate is not
part of the spatial key: features carry T channel blocks plus a per-(voxel,
t) occupancy mask.
"""

from __future__ import annotations

import torch

# Padding rows get coordinates far outside any plausible voxel index so that
# neighbour lookups for padded rows never alias real voxels.
PAD_COORD = 1 << 24
# Sentinel for "no row" in tables and failed lookups.
EMPTY = -1


def next_pow2(x: int) -> int:
    """Smallest power of two >= x (static helper)."""
    p = 1
    while p < x:
        p *= 2
    return p


def quantize(points: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """(N, 3) float points -> (N, 3) int32 voxel coords, floor semantics."""
    return torch.floor(points / voxel_size).to(torch.int32)


def devoxelize_flat(values, point2voxel, t_idx, *, num_time: int, channels: int):
    """Per-point values from an unreshaped slot tensor via a flat gather.

    `values` is any tensor whose row-major flattening is (slot-major, t,
    c minor), e.g. a (B, bs, bs, bs, T*C) brick head output, its z-folded
    (B, bs, bs, bs*T*C) form, or a (V, T*C) row head output.
    Returns (N, C) per-point values (0 for invalid points)."""
    flat = values.reshape(-1)
    base = (point2voxel.clamp(min=0).long() * num_time
            + t_idx.clamp(0, num_time - 1).long()) * channels
    if channels == 1:
        out = flat[base][:, None]
    else:
        out = flat[base[:, None] + torch.arange(channels, device=base.device)[None, :]]
    return out * (point2voxel >= 0).to(values.dtype)[:, None]
