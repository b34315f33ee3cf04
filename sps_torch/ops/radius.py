"""Scan -> map submap join (counterpart of sps_tpu/ops/radius.py).

"Which map points lie near the scan", two ways, both bit-equal to
sps_tpu's. `radius_join` (JOIN_MODE hash) is the exact Euclidean join: a
hash grid over the scan's cells (edge r) with fixed-capacity candidate
lists, the 27 neighbouring cells of each map point probed, exact distance
tests; its hash probes take host syncs (ops/hash.py). `radius_join_dense`
(JOIN_MODE dense) scatters the scan's occupied cells into a dense grid over
the scan's bounding box, dilates once by a 3^3 max and gathers once per map
point, with no host sync. `compact_mask` turns a mask into a
fixed-capacity index list.
"""

from __future__ import annotations

import numpy as np
import torch

from sps_torch.ops import hash as vhash
from sps_torch.ops import voxelize as vox

# The 27 neighbouring cells (x-slowest), padded to 30 with far-away offsets
# that never hit, probed 3 at a time as in sps_tpu.
JOIN_OFFSETS = np.concatenate([np.stack(np.meshgrid(*[np.arange(-1, 2)] * 3, indexing="ij"),
                                        -1).reshape(27, 3),
                               np.full((3, 3), 1 << 20)]).astype(np.int32)


def _cells(points: torch.Tensor, r: float) -> torch.Tensor:
    return torch.floor(points / r).to(torch.int32)


def radius_join(scan, scan_valid, queries, query_valid, r: float, *, cell_capacity: int,
                max_per_cell: int = 8):
    """For each query point: is a valid scan point within distance r?

    scan (N, 3) and queries (M, 3) float32; cell_capacity: the unique scan
    cells kept; max_per_cell: the candidate list of a cell. Points of a
    cell beyond its list (in scan order) are dropped and counted.

    Returns (mask (M,) bool, dropped: int32 count of scan points that
    exceeded their cell's list, possible false negatives if > 0)."""
    n, m = scan.shape[0], queries.shape[0]
    dev = scan.device
    cap, per = cell_capacity, max_per_cell
    zeros = torch.zeros(n, dtype=torch.int32, device=dev)
    grid, p2c, _ = vox.voxelize(_cells(scan, r), zeros, zeros, scan_valid, num_time=1,
                                voxel_capacity=cap)
    # Rank the points within their cell: a stable sort by cell (the order
    # decides which points a full cell drops), rank = position minus the
    # cell's first position. A valid point whose cell overflowed carries
    # -1 and, as in sps_tpu's indexing, addresses the dump row cap.
    key = torch.where(scan_valid, p2c, cap)
    order = torch.argsort(key, stable=True)
    sorted_cell = key[order]
    at = torch.remainder(sorted_cell, cap + 1).long()
    pos = torch.arange(n, device=dev)
    first = torch.full((cap + 1,), n, dtype=torch.int64, device=dev).scatter_reduce_(
        0, at, pos, "amin")
    rank = pos - first[at]
    ok = (sorted_cell < cap) & (rank < per)
    lists = torch.full((cap + 1, per), -1, dtype=torch.int64, device=dev)
    lists.index_put_((torch.where(ok, at, cap), torch.where(ok, rank, 0)), order)
    lists_t = lists[:cap].T.contiguous()  # (P, cells)
    dropped = ((rank >= per) & (sorted_cell < cap)).sum(dtype=torch.int32)

    qcells = _cells(queries, r)
    safe = torch.where(scan_valid[:, None], scan, torch.inf)
    r2 = float(np.float32(r * r))
    offs = vox.int_table(JOIN_OFFSETS, dev).reshape(10, 3, 3)
    hit = torch.zeros(m, dtype=torch.bool, device=dev)
    qx, qy, qz = (queries[:, i].repeat(3) for i in range(3))
    qv = query_valid.repeat(3)
    for off in offs:
        q = torch.cat([torch.zeros((3, m, 1), dtype=torch.int32, device=dev),
                       qcells[None] + off[:, None, :]], -1).reshape(3 * m, 4)
        cell_row = vhash.lookup(grid.table, q, qv)
        srow = cell_row.clamp(min=0).long()
        near = torch.zeros(3 * m, dtype=torch.bool, device=dev)
        for p in range(per):
            cand = torch.where(cell_row >= 0, lists_t[p][srow], -1)
            cs = cand.clamp(min=0)
            dx, dy, dz = safe[cs, 0] - qx, safe[cs, 1] - qy, safe[cs, 2] - qz
            near |= ((dx * dx + dy * dy + dz * dz) <= r2) & (cand >= 0)
        hit |= near.reshape(3, m).any(0)
    return hit & query_valid, dropped


def compact_mask(mask: torch.Tensor, capacity: int):
    """Compact the True positions of an (M,) mask into (capacity,) indices.

    Returns (indices int32, valid bool, overflow int32 count). Order-
    preserving; positions beyond capacity are dropped and counted."""
    m = mask.shape[0]
    mi = mask.to(torch.int32)
    pos = torch.cumsum(mi, 0) - 1
    total = mi.sum(dtype=torch.int32)
    dest = torch.where(mask & (pos < capacity), pos, capacity).long()
    idx = torch.zeros(capacity + 1, dtype=torch.int32, device=mask.device)
    idx.scatter_(0, dest, torch.arange(m, dtype=torch.int32, device=mask.device))
    valid = torch.arange(capacity, device=mask.device) < torch.clamp_max(total, capacity)
    overflow = torch.clamp_min(total - capacity, 0)
    return idx[:capacity], valid, overflow


def _dilate(a: torch.Tensor, tmp: torch.Tensor, dim: int):
    """tmp = 3-wide max of a along dim, zero beyond the ends ("SAME")."""
    n = a.shape[dim]
    tmp.copy_(a)
    if n > 1:
        lo, hi = tmp.narrow(dim, 1, n - 1), tmp.narrow(dim, 0, n - 1)
        torch.maximum(lo, a.narrow(dim, 0, n - 1), out=lo)
        torch.maximum(hi, a.narrow(dim, 1, n - 1), out=hi)


def radius_join_dense(scan, scan_valid, queries, query_valid, r: float, *, extent: tuple):
    """Keep the queries whose cell (edge r) lies within the Chebyshev
    one-cell neighbourhood of an occupied scan cell: a superset of the
    Euclidean ball of radius r (sps_tpu's documented deviation from the
    reference's k-d tree, docs/DESIGN.md §6).

    extent: (EX, EY, EZ) cells of the grid, whose origin is the scan's
    minimum cell minus 1; scan points outside it are dropped and counted.
    Memory: two uint8 grids of EX * EY * EZ cells (the 3^3 max runs as three
    separable passes between them).

    Returns (mask over queries, dropped scan points as an int32 count)."""
    dev = scan.device
    ex = torch.tensor(extent, dtype=torch.int64, device=dev)
    c = _cells(scan, r)
    big = torch.tensor(1 << 24, dtype=torch.int32, device=dev)
    cmin = torch.where(scan_valid[:, None], c, big).amin(0) - 1
    rel = (c - cmin).long()
    inb = scan_valid & ((rel >= 0) & (rel < ex)).all(-1)
    ncell = int(extent[0]) * int(extent[1]) * int(extent[2])
    flat = (rel[:, 0] * ex[1] + rel[:, 1]) * ex[2] + rel[:, 2]
    occ = torch.zeros(ncell + 1, dtype=torch.uint8, device=dev)
    occ.index_fill_(0, torch.where(inb, flat, ncell), 1)
    grid = occ[:ncell].view(*extent)
    tmp = torch.empty_like(grid)
    _dilate(grid, tmp, 0)
    _dilate(tmp, grid, 1)
    _dilate(grid, tmp, 2)
    o3 = tmp.view(-1)
    qc = (_cells(queries, r) - cmin).long()
    qin = query_valid & ((qc >= 0) & (qc < ex)).all(-1)
    qflat = (qc[:, 0] * ex[1] + qc[:, 1]) * ex[2] + qc[:, 2]
    hit = o3[qflat.clamp(0, ncell - 1)] > 0
    dropped = (scan_valid & ~inb).sum(dtype=torch.int32)
    return hit & qin, dropped
