"""The streaming filter's plain reference: one scan's scores and keep mask.

What SPS's filter computes for a scan against a resident map
(ibrahimhroob/SPS, predict on a map-frame scan), with the streaming
engine's rule for topology reuse:
  1. pose the scan into the map frame; voxelize (floor(xyz / voxel));
  2. sites: every scan voxel at t = 1, and at t = 0 each scan voxel that
     the map also holds (the map-overlap bit);
  3. with a cached brick set (a scan between two rebuilds), the scan's
     voxels whose brick (voxel >> log2(brick side)) is not in the set are
     dropped, and their points score exactly 0.5 (sigmoid of nothing);
  4. MinkUNet14 (benchmark/reference/minkunet.py) on the constant input
     0.5 at every site, eval-mode BN;
  5. each valid point takes the sigmoid of the head at its voxel's t = 1
     site; invalid points score 0; keep = score <= threshold and valid.
Float32 throughout, TF32 off. Nothing here imports the program.
"""

from __future__ import annotations

import torch

from benchmark.reference import minkunet as mk
from benchmark.reference import sparse as sp

SCAN_T, MAP_T = 1, 0


def voxels(xyz: torch.Tensor, voxel_size: float) -> torch.Tensor:
    return torch.floor(xyz / voxel_size).long()


def map_sites(map_points: torch.Tensor, voxel_size: float) -> sp.Sites:
    """The map's voxels as sites (b = 0, t = 0)."""
    v = voxels(map_points, voxel_size)
    z = torch.zeros((len(v), 1), dtype=torch.long, device=v.device)
    return sp.Sites.unique(torch.cat([z, v, z], 1))


def posed(xyz: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    return torch.einsum("ij,nj->ni", pose[:3, :3], xyz) + pose[:3, 3]


def bricks_of(xyz: torch.Tensor, valid: torch.Tensor, voxel_size: float,
              brick_side: int) -> torch.Tensor:
    """Sorted distinct brick keys of the valid points (a rebuild's cache)."""
    shift = brick_side.bit_length() - 1
    b = voxels(xyz[valid], voxel_size) >> shift
    z = torch.zeros((len(b), 1), dtype=torch.long, device=b.device)
    return torch.unique(sp.pack(torch.cat([z, b, z], 1)))


class Scan:
    """A scan's sites and each point's row at t = 1 (-1: invalid or missed)."""

    def __init__(self, xyz, valid, voxel_size, mapv: sp.Sites, cached=None, brick_side=8):
        v = voxels(xyz, voxel_size)
        ok = valid.clone()
        self.miss = torch.zeros_like(valid)
        if cached is not None:
            shift = brick_side.bit_length() - 1
            z = torch.zeros((len(v), 1), dtype=torch.long, device=v.device)
            key = sp.pack(torch.cat([z, v >> shift, z], 1))
            i = torch.searchsorted(cached, key).clamp(max=len(cached) - 1)
            self.miss = valid & (cached[i] != key)
            ok = valid & ~self.miss
        z = torch.zeros((len(v), 1), dtype=torch.long, device=v.device)
        scan = torch.cat([z, v, z + SCAN_T], 1)[ok]
        scan_sites = sp.Sites.unique(scan)
        both = scan_sites.coords.clone()
        both[:, 4] = MAP_T
        overlap = both[mapv.find(both) >= 0]
        self.sites = sp.Sites(torch.cat([scan_sites.coords, overlap]))
        self.point_row = torch.full((len(v),), -1, dtype=torch.long, device=v.device)
        self.point_row[ok] = self.sites.find(scan)
        self.valid = valid


def scores(w: dict, arch: mk.Arch, scan: Scan, **quant) -> torch.Tensor:
    """Per-point scores of one scan (float32)."""
    pyr = mk.Pyramid(scan.sites, arch)
    feats = torch.full((len(scan.sites), arch.in_channels), 0.5, device=scan.valid.device)
    head = mk.forward(w, pyr, feats, arch, **quant)[:, 0]
    row = scan.point_row
    s = torch.sigmoid(head[row.clamp(min=0)])
    s = torch.where(row >= 0, s, torch.where(scan.miss, 0.5, 0.0))
    return s * scan.valid.float()
