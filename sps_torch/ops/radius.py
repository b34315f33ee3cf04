"""Scan -> map submap join (counterpart of sps_tpu/ops/radius.py).

`radius_join_dense` answers "which map points lie near the scan" with a
dense cell-occupancy grid over the scan's bounding box: scatter the scan's
occupied cells (edge r), dilate once by a 3^3 max, and gather once per map
point. `compact_mask` turns the resulting mask into a fixed-capacity index
list. Both are plain PyTorch, free of host syncs, and bit-equal to
sps_tpu's. The hash-probe join (`radius_join`) is not ported yet.
"""

from __future__ import annotations

import torch


def _cells(points: torch.Tensor, r: float) -> torch.Tensor:
    return torch.floor(points / r).to(torch.int32)


def radius_join(*args, **kwargs):
    """The hash-probe join (JOIN_MODE hash) needs the port of ops/hash.py."""
    raise NotImplementedError(
        "JOIN_MODE hash is not ported (it needs ops/hash.py, ROADMAP module item 7); "
        "use JOIN_MODE dense")


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
