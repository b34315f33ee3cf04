"""Multi-level sparse topology of the gather engine (counterpart of
sps_tpu/ops/topology.py): voxel sets at every tensor stride, neighbour
tables for each kernel size, parent/child maps between strides.

Coordinates at level L are in units of the level's stride. Stride
semantics are MinkowskiEngine's:
  * down conv (kernel 2, stride 2): out[c] = sum_{k in {0,1}^3} W_k f[2c+k];
  * transpose conv: fine voxel u takes coarse voxel floor(u/2) through
    W_{u mod 2} (the parity);
  * stride-1 convs with odd kernels gather centred offsets (x-slowest).
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

import numpy as np
import torch

from sps_torch.ops import brick as bk
from sps_torch.ops import hash as vhash
from sps_torch.ops import voxelize as vox

# Lookups answered by one hash.lookup call: a neighbour table is looked up
# in chunks of offsets of at most this many queries (the chunking does not
# change the result; it bounds the probe loops' working set).
LOOKUP_QUERIES = 1 << 23


def kernel_offsets(size: int) -> np.ndarray:
    """Centred 3D offsets of an odd kernel, (size**3, 3) int32, x-slowest /
    z-fastest (np.ndindex order), sps_tpu's canonical order."""
    assert size % 2 == 1
    r = size // 2
    return np.asarray(list(itertools.product(range(-r, r + 1), repeat=3)), np.int32)


DOWN_OFFSETS = np.asarray(list(itertools.product((0, 1), repeat=3)), np.int32)


class Level(NamedTuple):
    """Sparse topology at one tensor stride.

    grid: VoxelGrid at this stride; nbr: {kernel size: (K, V) int32 rows of
    coords[i] + offset_k, or -1}; child: (8, V) rows in the finer level
    (DOWN_OFFSETS order; None at level 0); parent: (V,) row in the coarser
    level (None at the coarsest); parity: (V,) index into DOWN_OFFSETS of
    coords mod 2."""

    grid: vox.VoxelGrid
    nbr: dict
    child: torch.Tensor | None
    parent: torch.Tensor | None
    parity: torch.Tensor | None


def _neighbor_table(grid: vox.VoxelGrid, offsets: np.ndarray) -> torch.Tensor:
    """(K, V) neighbour rows for each static offset, -1 where absent.

    Centred odd kernels are centrally symmetric, so only the offsets before
    the centre are looked up; the mirror half follows by inversion (j is
    i's neighbour at d iff i is j's at -d) and the centre is the identity."""
    v = grid.coords.shape[0]
    k = offsets.shape[0]
    dev = grid.coords.device
    valid = torch.arange(v, device=dev) < grid.num_voxels
    symmetric = k % 2 == 1 and bool(np.all(offsets[::-1] == -offsets))
    nlook = k // 2 if symmetric else k
    chunk = max(1, min(nlook, LOOKUP_QUERIES // v))
    parts = []
    for c0 in range(0, nlook, chunk):
        offs = vox.int_table(offsets[c0:min(c0 + chunk, nlook)], dev)
        c = offs.shape[0]
        q = torch.cat([grid.coords[None, :, :1].expand(c, v, 1),
                       grid.coords[None, :, 1:] + offs[:, None, :]], -1).reshape(c * v, 4)
        qv = valid[None, :].expand(c, v).reshape(-1)
        parts.append(vhash.lookup(grid.table, q, qv).reshape(c, v))
    rows = torch.cat(parts)
    if not symmetric:
        return rows
    centre = torch.where(valid, torch.arange(v, dtype=torch.int32, device=dev), vhash.EMPTY)
    return torch.cat([rows, centre[None], bk.invert_rows(rows, v).flip(0)])


def build_levels(grid0: vox.VoxelGrid, *, num_levels: int, capacities: tuple,
                 kernel_sizes: tuple) -> list[Level]:
    """The stride pyramid from the stride-1 grid, finest first.

    capacities: voxel capacity per level (capacities[0] is grid0's);
    kernel_sizes: per level, the odd kernel sizes that need neighbour tables
    (SPS's MinkUNet14: ((5, 3), (3,), (3,), (3,), (3,)))."""
    assert len(capacities) == num_levels and len(kernel_sizes) == num_levels
    assert capacities[0] == grid0.coords.shape[0]
    dev = grid0.coords.device
    grids, nbrs, parent_of = [grid0], [], []
    for li in range(num_levels):
        grid = grids[li]
        nbrs.append({ks: _neighbor_table(grid, kernel_offsets(ks)) for ks in kernel_sizes[li]})
        if li == num_levels - 1:
            break
        v = grid.coords.shape[0]
        valid = torch.arange(v, device=dev) < grid.num_voxels
        # Dedup the halved coords: "points" are the fine voxels; per-t
        # occupancy ORs over the children (a scatter-max).
        cgrid, fine2coarse, _ = vox.voxelize(
            grid.coords[:, 1:] >> 1, grid.coords[:, 0], torch.zeros(v, dtype=torch.int32,
                                                                    device=dev),
            valid, num_time=1, voxel_capacity=capacities[li + 1])
        t = grid.occ.shape[1]
        cap = capacities[li + 1]
        safe = torch.where(fine2coarse >= 0, fine2coarse, cap).long()
        occ_c = torch.zeros((cap + 1, t), dtype=torch.float32, device=dev).scatter_reduce_(
            0, safe[:, None].expand(v, t), grid.occ * valid[:, None], "amax")
        grids.append(cgrid._replace(occ=occ_c[:cap]))
        parent_of.append(fine2coarse)

    levels = []
    for li, grid in enumerate(grids):
        parent = parent_of[li] if li < num_levels - 1 else None
        parity = None
        if parent is not None:
            xyz = grid.coords[:, 1:] & 1
            parity = (xyz[:, 0] << 2) | (xyz[:, 1] << 1) | xyz[:, 2]
        child = None
        if li > 0:
            # Fine voxel f with parity p is the (p, parent[f]) child: a
            # scatter of the downsample's assignment, no fresh lookups.
            fine = grids[li - 1]
            v, vf = grid.coords.shape[0], fine.coords.shape[0]
            validf = torch.arange(vf, device=dev) < fine.num_voxels
            pxyz = fine.coords[:, 1:] & 1
            pflat = (pxyz[:, 0] << 2) | (pxyz[:, 1] << 1) | pxyz[:, 2]
            fp = parent_of[li - 1]
            dest = torch.where(validf & (fp >= 0), fp, v)
            child = torch.full((8, v + 1), vhash.EMPTY, dtype=torch.int32, device=dev)
            child[pflat.long(), dest.long()] = torch.arange(vf, dtype=torch.int32, device=dev)
            child = child[:, :v]
        levels.append(Level(grid=grid, nbr=nbrs[li], child=child, parent=parent,
                            parity=parity))
    return levels
