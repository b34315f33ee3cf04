"""Voxel quantization, deduplication and devoxelization (counterpart of
sps_tpu/ops/voxelize.py).

`voxelize` dedups points through the hash table of ops/hash.py; its
compact rows are the table's occupied slots in slot order, as sps_tpu's.
Quantization uses floor semantics for negative coordinates too, as
MinkowskiEngine's TensorField.sparse() does. The time coordinate is not
part of the spatial key: features carry T channel blocks plus a per-(voxel,
t) occupancy mask.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sps_torch.ops import hash as vhash
from sps_torch.ops.hash import EMPTY, next_pow2  # noqa: F401 (the port's callers use them here)

# Padding rows get coordinates far outside any plausible voxel index so that
# neighbour lookups for padded rows never alias real voxels.
PAD_COORD = 1 << 24

_TABLES: dict = {}


def int_table(rows, device) -> torch.Tensor:
    """A static int32 table on `device`, uploaded once per device: a
    host-to-device copy inside a scan would synchronise the stream."""
    key = (tuple(map(tuple, rows)), str(device))
    if key not in _TABLES:
        _TABLES[key] = torch.as_tensor(np.asarray(rows), dtype=torch.int32, device=device)
    return _TABLES[key]


class VoxelGrid(NamedTuple):
    """A batched, fixed-capacity 3D sparse voxel grid with T time slots.

    coords (V, 4) int32 [batch, x, y, z] (PAD_COORD rows beyond
    num_voxels); occ (V, T) f32, 1 where the (voxel, t) slot holds a point;
    num_voxels () int32; table: HashTable over the coords giving compact
    rows; overflow () bool, True when the unique voxels exceeded V (the
    extra voxels are dropped)."""

    coords: torch.Tensor
    occ: torch.Tensor
    num_voxels: torch.Tensor
    table: vhash.HashTable
    overflow: torch.Tensor


def quantize(points: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """(N, 3) float points -> (N, 3) int32 voxel coords, floor semantics."""
    return torch.floor(points / voxel_size).to(torch.int32)


def compact_slots(raw: vhash.HashTable, capacity: int):
    """Occupied slots of a freshly built table -> compact rows in slot order.

    Returns (row_of_slot (S,) int32 (prefix count minus one), kept (S,) bool
    (occupied and within capacity), coords (capacity, 4) of the kept rows'
    keys (PAD_COORD beyond), the table with compact row ids, num (clamped),
    overflow)."""
    occupied = raw.rows >= 0
    row_of_slot = torch.cumsum(occupied, 0, dtype=torch.int32) - 1
    num = occupied.sum(dtype=torch.int32)
    kept = occupied & (row_of_slot < capacity)
    dest = torch.where(kept, row_of_slot, capacity).long()
    coords = torch.full((capacity + 1, 4), PAD_COORD, dtype=torch.int32, device=raw.rows.device)
    coords.index_put_((dest,), raw.keys)
    table = vhash.HashTable(keys=raw.keys, rows=torch.where(kept, row_of_slot, EMPTY))
    return row_of_slot, coords[:capacity], table, torch.clamp_max(num, capacity), num > capacity


def row_of_points(row_of_slot, slot_of, valid, capacity: int):
    """Compact row per point from its slot (EMPTY if invalid, unresolved or
    beyond capacity)."""
    r = torch.where(valid & (slot_of >= 0), row_of_slot[slot_of.clamp(min=0).long()], EMPTY)
    return torch.where(r < capacity, r, EMPTY)


def voxelize(coords, batch_idx, t_idx, valid, *, num_time: int, voxel_capacity: int,
             features=None):
    """Deduplicate (N, 3) int32 point coordinates into a VoxelGrid.

    Returns (grid, point2voxel, pooled): point2voxel (N,) int32 compact row
    per point (EMPTY if invalid); pooled (V, T, C) the per-(voxel, t) mean
    of `features` (N, C) (ME's UNWEIGHTED_AVERAGE), of ones when None."""
    n = coords.shape[0]
    dev = coords.device
    key = torch.cat([batch_idx[:, None].to(torch.int32), coords.to(torch.int32)], -1)
    raw, slot_of = vhash.build(key, valid, next_pow2(max(2 * n, 16)))
    row_of_slot, coords_c, table, num, overflow = compact_slots(raw, voxel_capacity)
    p2v = row_of_points(row_of_slot, slot_of, valid, voxel_capacity)

    # Per-(voxel, t) counts and sums in flat buffers (a dump row at V).
    if features is None:
        features = torch.ones((n, 1), dtype=torch.float32, device=dev)
    c = features.shape[-1]
    pv = torch.where(p2v >= 0, p2v, voxel_capacity).long()
    idx = pv * num_time + t_idx.clamp(0, num_time - 1).long()
    nslot = (voxel_capacity + 1) * num_time
    w = valid.to(torch.float32)
    cnt = torch.zeros(nslot, dtype=torch.float32, device=dev).index_add_(0, idx, w)
    sums = torch.zeros((nslot, c), dtype=torch.float32, device=dev).index_add_(
        0, idx, features * valid[:, None].to(features.dtype))
    nreal = voxel_capacity * num_time
    occ = (cnt[:nreal] > 0).to(torch.float32).reshape(voxel_capacity, num_time)
    pooled = (sums[:nreal] / torch.clamp_min(cnt[:nreal], 1.0)[:, None]).reshape(
        voxel_capacity, num_time, c)
    grid = VoxelGrid(coords=coords_c, occ=occ, num_voxels=num, table=table, overflow=overflow)
    return grid, p2v, pooled


def devoxelize(values, point2voxel, t_idx):
    """Per-(voxel, t) values (V, T, C) gathered back to points (ME's .slice()):
    (N, C), 0 where point2voxel is EMPTY."""
    out = values[point2voxel.clamp(min=0).long(), t_idx.clamp(0, values.shape[1] - 1).long()]
    return out * (point2voxel >= 0).to(values.dtype)[:, None]


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
