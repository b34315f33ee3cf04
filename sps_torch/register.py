"""Scan-to-map registration: point-to-plane ICP, Gauss-Newton (counterpart
of sps_tpu/register.py).

Each map voxel carries a centroid and a normal (the covariance's smallest
eigenvector), computed once. Correspondences come from a dense AABB
cell -> nearest-voxel LUT (one gather per point) or, for maps past the LUT
budget, from 27 neighbour probes into the sorted voxel keys. A fixed number
of Gauss-Newton iterations on se(3) runs per level, all on tensors of the
caller's device: no value is read back to the host after the map is built.

The voxel rows here are in sorted-key order (torch.unique), not sps_tpu's
hash order; every per-point result (centroid, normal, hit, distance, pose)
is the same.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sps_torch.ops import voxelize as vox
from sps_torch.structs import resolve_device

EMPTY = vox.EMPTY
# Dense-LUT budget: beyond this many cells (int32 LUT bytes = 4 * NC) the map
# keeps the probing correspondence path.
_LUT_MAX_CELLS = 64_000_000
# Cells per step of the LUT's 27-neighbour pass (bounds its temporaries).
_LUT_CHUNK = 1 << 22
# Voxel keys pack (x, y, z) + _KEY_OFF into 21 bits each.
_KEY_OFF = 1 << 20
# The registration settings every caller uses (sps_tpu's defaults):
# Gauss-Newton steps on the finest level, the pyramid's voxel sizes in units
# of the filter's voxel (coarsest first), the yaw hypotheses tried on the
# coarsest level (radians either side, count), the coarse levels' point
# stride, and the Huber width on the finest level (metres).
ICP_ITERS = 12
REG_VOXELS = (16, 4)
YAW_SPAN, YAW_STEPS = 0.6, 13
COARSE_STRIDE = 8
HUBER = 0.3


class VoxelMap(NamedTuple):
    """Registration map: sorted voxel keys + per-voxel centroid and normal,
    and optionally the dense cell -> nearest-voxel LUT (lut_origin: cell
    coordinate of lut[0]; lut_dims: cells per axis; one EMPTY entry past
    the last cell, which out-of-box and invalid points read)."""

    keys: torch.Tensor  # (V,) int64, sorted
    centroids: torch.Tensor  # (V, 3)
    normals: torch.Tensor  # (V, 3)
    num_voxels: int
    voxel_size: float
    lut: torch.Tensor | None = None  # (NC + 1,) int32 nearest-voxel row; lut[NC] = EMPTY
    lut_origin: torch.Tensor | None = None  # (3,) int32
    lut_dims: torch.Tensor | None = None  # (3,) int32 cells per axis
    lut_strides: torch.Tensor | None = None  # (3,) int32: flat cell = cell . strides


def _pack(coords: torch.Tensor) -> torch.Tensor:
    """(..., 3) int voxel coords -> (...) int64 keys."""
    c = coords.long() + _KEY_OFF
    return (c[..., 0] << 42) | (c[..., 1] << 21) | c[..., 2]


def _smallest_evec(cov: torch.Tensor) -> torch.Tensor:
    """Smallest eigenvector of symmetric PD (V, 3, 3) matrices by 16 power
    iterations on the scale-normalised adjugate (whose dominant eigenvector
    is the matrix's smallest); a voxel whose adjugate is rank deficient
    keeps its previous direction."""
    a, b, c = cov[:, 0, 0], cov[:, 0, 1], cov[:, 0, 2]
    d, e, f = cov[:, 1, 1], cov[:, 1, 2], cov[:, 2, 2]
    m11 = d * f - e * e
    m12 = c * e - b * f
    m13 = b * e - c * d
    m22 = a * f - c * c
    m23 = b * c - a * e
    m33 = a * d - b * b
    adj = torch.stack([torch.stack([m11, m12, m13], -1), torch.stack([m12, m22, m23], -1),
                       torch.stack([m13, m23, m33], -1)], 1)  # (V, 3, 3)
    s = torch.clamp_min(adj.abs().amax(dim=(1, 2)), 1e-30)[:, None, None]
    adj = adj / s
    r0, r1, r2 = adj[:, 0], adj[:, 1], adj[:, 2]
    v = torch.full(r0.shape, 3.0**-0.5, dtype=cov.dtype, device=cov.device)

    def dot(r, x):
        return r[:, 0] * x[:, 0] + r[:, 1] * x[:, 1] + r[:, 2] * x[:, 2]

    for _ in range(16):
        w = torch.stack([dot(r0, v), dot(r1, v), dot(r2, v)], -1)
        nrm = torch.sqrt(dot(w, w))[:, None]
        v = torch.where(nrm > 1e-20, w / torch.clamp_min(nrm, 1e-30), v)
    return v


def build_voxel_map(map_points: np.ndarray, voxel_size: float, lut: bool = True,
                    device=None) -> VoxelMap:
    """One-time map digest: centroid + covariance normal per voxel, and the
    dense LUT when the map's cell box fits _LUT_MAX_CELLS."""
    dev = resolve_device(device)
    map_points = np.asarray(map_points, np.float32)[:, :3]
    pts = torch.as_tensor(map_points, device=dev)
    keys, inv = torch.unique(_pack(vox.quantize(pts, voxel_size)), return_inverse=True)
    nv = keys.shape[0]
    cnt = torch.zeros(nv, device=dev).index_add_(0, inv, torch.ones_like(pts[:, 0]))
    cent = torch.zeros(nv, 3, device=dev).index_add_(0, inv, pts) / torch.clamp_min(
        cnt[:, None], 1.0)
    outer = pts[:, :, None] * pts[:, None, :]
    so = torch.zeros(nv, 3, 3, device=dev).index_add_(0, inv, outer)
    del outer
    # E[xx^T] - mu mu^T with one rounding, as XLA fuses it in sps_tpu (the
    # product is exact in f64). It decides the normal of a voxel with one or
    # two points, whose covariance is rounding noise plus 1e-6 I.
    mean_outer = so / torch.clamp_min(cnt[:, None, None], 1.0)
    c64 = cent.double()
    cov = (mean_outer.double() - c64[:, :, None] * c64[:, None, :]).float()
    cov = cov + 1e-6 * torch.eye(3, device=dev)
    vm = VoxelMap(keys, cent, _smallest_evec(cov), nv, voxel_size)
    if not lut:
        return vm
    cmin = np.floor(map_points.min(axis=0) / voxel_size).astype(np.int64) - 1
    cmax = np.floor(map_points.max(axis=0) / voxel_size).astype(np.int64) + 1
    dims = tuple(int(x) for x in (cmax - cmin + 1))
    nc = dims[0] * dims[1] * dims[2]
    if nc > _LUT_MAX_CELLS:
        return vm
    origin = torch.as_tensor(cmin.astype(np.int32), device=dev)
    c = vox.quantize(pts, voxel_size) - origin
    flat = (c[:, 0] * dims[1] + c[:, 1]) * dims[2] + c[:, 2]
    rd_ext = torch.full((nc + 1,), EMPTY, dtype=torch.int32, device=dev)
    # The box holds every map point, so no point lands in the spare slot.
    rd_ext.scatter_reduce_(0, flat.clamp(0, nc).long(), inv.to(torch.int32), "amax",
                           include_self=True)
    best_row = torch.full((nc + 1,), EMPTY, dtype=torch.int32, device=dev)
    for start in range(0, nc, _LUT_CHUNK):
        stop = min(nc, start + _LUT_CHUNK)
        best_row[start:stop] = _nearest_candidates(rd_ext, cent, start, stop, dims, origin,
                                                   voxel_size)
    return vm._replace(
        lut=best_row, lut_origin=origin,
        lut_dims=torch.tensor(dims, dtype=torch.int32, device=dev),
        lut_strides=torch.tensor([dims[1] * dims[2], dims[2], 1], dtype=torch.int32, device=dev))


def _nearest_candidates(rd_ext, cent, start, stop, dims, origin, voxel_size):
    """Cells [start, stop): the row of the nearest voxel centroid (to the
    cell centre) among the 27 neighbour cells; a strictly nearer candidate
    replaces the best in dx, dy, dz order."""
    nc = dims[0] * dims[1] * dims[2]
    iota = torch.arange(start, stop, dtype=torch.int32, device=cent.device)
    cx = iota // (dims[1] * dims[2])
    cy = (iota // dims[2]) % dims[1]
    cz = iota % dims[2]
    center = ((torch.stack([cx, cy, cz], -1) + origin).float() + 0.5) * voxel_size
    best_d2 = torch.full(iota.shape, float("inf"), device=cent.device)
    best_row = torch.full(iota.shape, EMPTY, dtype=torch.int32, device=cent.device)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                nx_, ny_, nz_ = cx + dx, cy + dy, cz + dz
                inb = ((nx_ >= 0) & (nx_ < dims[0]) & (ny_ >= 0) & (ny_ < dims[1])
                       & (nz_ >= 0) & (nz_ < dims[2]))
                nf = (nx_ * dims[1] + ny_) * dims[2] + nz_
                r = rd_ext[torch.where(inb, nf, nc).long()]
                dc = cent[r.clamp(min=0).long()] - center
                d2 = dc[:, 0] * dc[:, 0] + dc[:, 1] * dc[:, 1] + dc[:, 2] * dc[:, 2]
                d2 = torch.where(r >= 0, d2, float("inf"))
                take = d2 < best_d2
                best_d2 = torch.where(take, d2, best_d2)
                best_row = torch.where(take, r, best_row)
    return best_row


def _skew(k: torch.Tensor) -> torch.Tensor:
    """(3,) -> (3, 3) cross-product matrix (row i: e_i x k)."""
    eye = torch.eye(3, dtype=k.dtype, device=k.device)
    return torch.linalg.cross(eye, k.expand(3, 3))


def _exp_se3(delta: torch.Tensor) -> torch.Tensor:
    """se(3) exponential: delta = (omega[3], v[3]) -> 4x4 transform."""
    w, v = delta[:3], delta[3:]
    th = torch.sqrt((w * w).sum()) + 1e-12
    kx = _skew(w / th)
    s, c = torch.sin(th), torch.cos(th)
    # [I, kx, kx^2] weighted by [1, s, 1 - c] (rotation) and [1, (1 - c) / th,
    # (th - s) / th] (the V of the translation).
    basis = torch.stack([torch.eye(3, dtype=delta.dtype, device=delta.device), kx, kx @ kx])
    one = torch.ones_like(th)
    coef = torch.stack([torch.stack([one, s, 1 - c]), torch.stack([one, (1 - c) / th,
                                                                   (th - s) / th])])
    r, vmat = torch.einsum("ab,bij->aij", coef, basis).unbind(0)
    bottom = torch.eye(4, dtype=delta.dtype, device=delta.device)[3:]
    return torch.cat([torch.cat([r, (vmat @ v)[:, None]], 1), bottom], 0)


def _lut_rows(vmap: VoxelMap, cell, valid):
    """(N, 3) integer cell coordinates relative to the LUT's origin -> LUT
    row per point and hit; EMPTY outside the box, for invalid points, and
    where no voxel lies within the 27 cells."""
    nc = vmap.lut.shape[0] - 1
    inb = ((cell >= 0) & (cell < vmap.lut_dims)).all(-1)
    flat = (cell * vmap.lut_strides).sum(-1)
    row = vmap.lut[torch.where(inb & valid, flat, nc)]
    return row, (row >= 0) & valid


def _correspond(vmap: VoxelMap, p: torch.Tensor, valid: torch.Tensor):
    """Nearest map-voxel centroid among the 27 neighbour voxels of each
    point: (centroids, normals, hit). With a LUT one gather per point
    (quantized by division, vox.quantize); without, 27 probes of the sorted
    keys and the nearest centroid to the point (first on ties)."""
    if vmap.lut is not None:
        row, hit = _lut_rows(vmap, vox.quantize(p, vmap.voxel_size) - vmap.lut_origin, valid)
        safe = row.clamp(min=0).long()
        return vmap.centroids[safe], vmap.normals[safe], hit
    coords = vox.quantize(p, vmap.voxel_size)
    r = torch.arange(-1, 2, device=p.device)
    offs = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(27, 1, 3)
    q = _pack(coords[None] + offs)  # (27, M)
    nv = vmap.num_voxels
    pos = torch.searchsorted(vmap.keys, q).clamp(max=nv - 1)
    rows = torch.where((vmap.keys[pos] == q) & valid[None], pos, EMPTY)
    cands = vmap.centroids[rows.clamp(min=0)] - p[None]  # (27, M, 3)
    d2 = cands[..., 0] * cands[..., 0] + cands[..., 1] * cands[..., 1] + cands[..., 2] * cands[..., 2]
    d2 = torch.where(rows >= 0, d2, float("inf"))
    best = torch.argmin(d2, dim=0)
    row = torch.gather(rows, 0, best[None])[0]
    hit = (row >= 0) & valid
    safe = row.clamp(min=0)
    return vmap.centroids[safe], vmap.normals[safe], hit


def point_map_distance(vmap: VoxelMap, p: torch.Tensor, valid: torch.Tensor,
                       cap: float = 1.0) -> torch.Tensor:
    """Per-point distance to the nearest map-voxel centroid, clipped to cap
    (cap where no correspondence lies within the 27-cell search or outside
    the LUT window); 0 for invalid points."""
    cc, _, hit = _correspond(vmap, p, valid)
    dc = cc - p
    d = torch.sqrt(dc[:, 0] * dc[:, 0] + dc[:, 1] * dc[:, 1] + dc[:, 2] * dc[:, 2])
    d = torch.where(hit, torch.clamp_max(d, cap), cap)
    return torch.where(valid, d, 0.0).float()


def _rot_z(yaw: torch.Tensor) -> torch.Tensor:
    """(..., ) yaw -> (..., 3, 3) rotations about z."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    z, o = torch.zeros_like(yaw), torch.ones_like(yaw)
    return torch.stack([c, -s, z, s, c, z, z, z, o], -1).reshape(yaw.shape + (3, 3))


def yaw_search(vmap: VoxelMap, scan, valid, pose, *, huber: float = HUBER):
    """Score YAW_STEPS yaw rotations of the prior about the sensor origin
    (pose @ Rz) on the map with a bounded robust cost (a point with no
    correspondence pays the Huber ceiling); returns the best, first on
    ties. All hypotheses in one batch, no host sync."""
    steps = YAW_STEPS
    yaws = torch.linspace(-YAW_SPAN, YAW_SPAN, steps, dtype=torch.float64,
                          device=scan.device).float()
    r3 = pose[:3, :3] @ _rot_z(yaws)  # (S, 3, 3)
    p = torch.einsum("nj,sij->sni", scan, r3) + pose[:3, 3]
    n = scan.shape[0]
    vv = valid.repeat(steps)
    cc, nn, hit = _correspond(vmap, p.reshape(steps * n, 3), vv)
    res = (nn * (p.reshape(-1, 3) - cc)).sum(-1)
    e = torch.where(hit, torch.clamp_max(res * res, huber * huber), huber * huber)
    v = valid.to(e.dtype)
    costs = (e.view(steps, n) * v).sum(-1) / torch.clamp_min(v.sum(), 1.0)
    best = torch.argmin(costs).reshape(1)
    rz = _rot_z(yaws.index_select(0, best))[0]
    return torch.cat([torch.cat([pose[:3, :3] @ rz, pose[:3, 3:]], 1), pose[3:]], 0)


def _correspond_cols(vmap: VoxelMap, cn, p, valid):
    """The ICP's LUT correspondence, quantized as floor(p * (1 /
    voxel_size)) (not by division, as _correspond is): (N, 6) centroid and
    normal rows of `cn` = [centroids, normals] from one gather, and hit."""
    cell = torch.floor(p * (1.0 / vmap.voxel_size)).to(torch.int32) - vmap.lut_origin
    row, hit = _lut_rows(vmap, cell, valid)
    return cn[row.clamp(min=0)], hit


def register(vmap: VoxelMap, scan, valid, init_pose, *, iters: int = ICP_ITERS,
             damping: float = 1e-4, huber: float = HUBER, point_w=None):
    """Point-to-plane ICP of an (N, 3) sensor-frame scan against the map:
    `iters` Gauss-Newton steps with Huber weights; returns (pose 4x4,
    {"inliers", "rmse"}). point_w: optional (N,) per-point confidence
    multiplied into the robust weights. Each step is a few dozen whole-array
    kernels: the normal equations are one (6, N) x (N, 6) product and the
    6 x 6 solve does not check for errors (no wait on the device)."""
    use_lut = vmap.lut is not None
    cn = torch.cat([vmap.centroids, vmap.normals], -1) if use_lut else None
    eye6 = torch.eye(6, dtype=scan.dtype, device=scan.device) * damping

    def residuals(pose):
        p = torch.addmm(pose[:3, 3], scan, pose[:3, :3].T)
        if use_lut:
            g, hit = _correspond_cols(vmap, cn, p, valid)
            c, nrm = g[:, :3], g[:, 3:]
        else:
            c, nrm, hit = _correspond(vmap, p, valid)
        r = ((p - c) * nrm).sum(-1)
        # d r / d omega = p x n
        jac = torch.cat([torch.linalg.cross(p, nrm), nrm], -1)
        return jac, r, hit

    pose = init_pose
    for _ in range(iters):
        jac, r, hit = residuals(pose)
        absr = r.abs() + 1e-12
        w = torch.where(absr < huber, 1.0, huber / absr) * hit
        if point_w is not None:
            w = w * point_w
        jw = jac * w[:, None]
        h = torch.addmm(eye6, jw.T, jac)
        delta = -torch.linalg.solve_ex(h, jw.T @ r)[0]
        pose = _exp_se3(delta) @ pose
    _, r, hit = residuals(pose)
    w = hit.to(r.dtype)
    if point_w is not None:
        w = w * point_w
    rmse = torch.sqrt((w * r * r).sum() / torch.clamp_min(w.sum(), 1.0))
    return pose, {"inliers": hit.sum(dtype=torch.int32), "rmse": rmse}


def register_pyramid(vmaps, scan, valid, init_pose, *, yaw: bool = True, point_w=None):
    """Coarse-to-fine ICP over VoxelMaps (coarsest first): a yaw search on
    the coarsest level (unless yaw=False), every COARSE_STRIDE-th point and
    ICP_ITERS // 2 iterations with a Huber width scaled by the voxel ratio
    on the coarse levels, every point and ICP_ITERS on the finest."""
    pose, stats = init_pose, None
    for li, vm in enumerate(vmaps):
        last = li == len(vmaps) - 1
        s, v, pw = scan, valid, point_w
        if not last:
            s, v = scan[::COARSE_STRIDE], valid[::COARSE_STRIDE]
            pw = point_w[::COARSE_STRIDE] if point_w is not None else None
        wide = HUBER * vm.voxel_size / vmaps[-1].voxel_size
        if li == 0 and yaw:
            pose = yaw_search(vm, s, v, pose, huber=wide)
        it = ICP_ITERS if last else ICP_ITERS // 2
        pose, stats = register(vm, s, v, pose, iters=it, huber=HUBER if last else wide,
                               point_w=pw)
    return pose, stats


def build_pyramid(map_points, voxel_size: float, device=None):
    """The registration maps at REG_VOXELS x voxel_size, coarsest first."""
    return tuple(build_voxel_map(map_points, v * voxel_size, device=device)
                 for v in REG_VOXELS)
