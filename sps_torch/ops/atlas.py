"""Dense brick atlas: probe-free topology over a static AABB window
(counterpart of sps_tpu/ops/atlas.py).

At brick granularity the working set is small, so a dense int32 "atlas"
mapping brick cell -> compact brick row over the scan's AABB replaces a
probing hash table. Dedup/compaction is a scatter plus a prefix count over
cells; point -> brick row, the 27-neighbourhood and the stride-2
downsample are single dense gathers and scatters.

Shapes stay static: the atlas extent and every capacity are fixed, the
AABB origin is data, and overflow is a flag (never an exception, never a
host sync). Scatters that could address past a capacity write into one
extra dump row that is sliced off, and no scatter writes two different
values to one kept index, so results do not depend on write order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sps_torch.ops import brick as bk
from sps_torch.ops.sparse_conv import take_rows
from sps_torch.ops.voxelize import EMPTY, PAD_COORD, int_table


@dataclasses.dataclass
class AtlasGrid:
    """Brick grid whose lookup structure is a dense AABB atlas."""

    coords: torch.Tensor  # (Bcap, 4) int32 [batch, bx, by, bz]; PAD_COORD beyond num
    occ: torch.Tensor  # (Bcap, bs, bs, bs, T) bfloat16 (exact 0/1 values)
    num_bricks: torch.Tensor  # () int32
    atlas: torch.Tensor  # (NB*NX*NY*NZ,) int32 cell -> brick row
    origin: torch.Tensor  # (3,) int32 brick coordinate of cell (0, 0, 0)
    overflow: torch.Tensor  # () bool
    extent: tuple = ()  # (NB, NX, NY, NZ), static

    def _replace(self, **kw):
        return dataclasses.replace(self, **kw)


def _ncell(extent) -> int:
    return int(np.prod(extent))


def _cells(batch_idx, bc, origin, extent):
    """Flat cell ids (int64; ncell where out of window) + in-window mask for
    (N,) batch ids and (N, 3) brick coords."""
    nb, nx, ny, nz = extent
    rel = (bc - origin[None, :]).long()
    inb = ((batch_idx >= 0) & (batch_idx < nb) & (rel >= 0).all(dim=-1)
           & (rel[:, 0] < nx) & (rel[:, 1] < ny) & (rel[:, 2] < nz))
    flat = ((batch_idx.long() * nx + rel[:, 0]) * ny + rel[:, 1]) * nz + rel[:, 2]
    return torch.where(inb, flat, _ncell(extent)), inb


def _with_empty(atlas: torch.Tensor) -> torch.Tensor:
    return torch.cat([atlas, atlas.new_full((1,), EMPTY)])


def atlas_rows(grid: AtlasGrid, batch_idx, bc):
    """Brick rows (int32) for (N,) batch ids + (N, 3) brick coords (EMPTY if
    absent or out of window). One gather, no probing."""
    flat, inb = _cells(batch_idx, bc, grid.origin, grid.extent)
    r = _with_empty(grid.atlas)[flat]
    return torch.where(inb, r, EMPTY)


def _prefix_rows(occb: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix count minus one over a cell-occupancy bitmap."""
    return torch.cumsum(occb.to(torch.int32), 0, dtype=torch.int32) - 1


def _occupied_cells(flat, ok, ncell):
    """(ncell,) int32 bitmap of the cells holding at least one ok entry."""
    occ = torch.zeros(ncell + 1, dtype=torch.int32, device=flat.device)
    # index_fill_, not occ[idx] = 1: assigning a Python scalar through an
    # index copies it to the card and waits for the device.
    occ.index_fill_(0, torch.where(ok, flat, ncell).long(), 1)
    return occ[:ncell]


def _compact(occ_cells, capacity, extent, origin, src_cells, src_ok):
    """Occupancy bitmap over cells -> (atlas, coords, num, overflow).

    atlas[cell] = compact brick row (EMPTY if vacant); coords[row] = [batch,
    bx, by, bz] of that brick (PAD_COORD beyond num). The row -> cell
    inversion scatters the source entities' cells (points at L0, fine
    bricks at coarser levels): every source of one row carries that row's
    cell, so duplicate writes agree."""
    nb, nx, ny, nz = extent
    ncell = _ncell(extent)
    occb = occ_cells > 0
    row_of_cell = _prefix_rows(occb)
    num = occb.sum(dtype=torch.int32)
    overflow = num > capacity
    atlas = torch.where(occb & (row_of_cell < capacity), row_of_cell, EMPTY)
    rows = torch.where(src_ok, _with_empty(atlas)[src_cells], EMPTY)
    dest = torch.where(rows >= 0, rows, capacity).long()
    cell_of_row = torch.zeros(capacity + 1, dtype=torch.int32, device=atlas.device)
    cell_of_row[dest] = src_cells.to(torch.int32)
    cell_of_row = cell_of_row[:capacity]
    b = cell_of_row // (nx * ny * nz)
    r = cell_of_row % (nx * ny * nz)
    cx = r // (ny * nz)
    cy = (r // nz) % ny
    cz = r % nz
    coords = torch.stack(
        [b, cx + origin[0], cy + origin[1], cz + origin[2]], dim=-1
    ).to(torch.int32)
    num_c = torch.clamp_max(num, capacity)
    valid_rows = torch.arange(capacity, device=atlas.device) < num_c
    coords = torch.where(valid_rows[:, None], coords, PAD_COORD)
    return atlas, coords, num_c, overflow


def voxelize_bricks(coords, batch_idx, t_idx, valid, *, num_time: int,
                    brick_capacity: int, brick_side: int, extent: tuple, features=None):
    """Dedup integer voxel coords into atlas bricks.

    Returns (grid, point2slot): point2slot is the flat index brick_row *
    bs^3 + local into the (B*bs^3,) slot view (EMPTY if invalid). The
    dynamic origin is the min valid brick coordinate; points outside the
    static window set the overflow flag and are dropped. With `features`
    (N, C) it returns (grid, point2slot, pooled) as well: the mean of the
    features per (brick, voxel, t), (B, bs, bs, bs, T*C), 0 where no point
    falls."""
    bs = brick_side
    assert bs & (bs - 1) == 0 and bs >= 2
    shift = bs.bit_length() - 1
    bvol = bs**3
    ncell = _ncell(extent)
    dev = coords.device

    bc = coords >> shift  # arithmetic shift = floor division for negatives
    local = coords & (bs - 1)
    origin = torch.where(valid[:, None], bc, 1 << 30).amin(dim=0).to(torch.int32)
    flat, inb = _cells(batch_idx, bc, origin, extent)
    ok = valid & inb
    out_of_window = (valid & ~inb).any()

    occ_cells = _occupied_cells(flat, ok, ncell)
    atlas, coords_c, num, overflow = _compact(
        occ_cells, brick_capacity, extent, origin, src_cells=flat, src_ok=ok
    )
    overflow = overflow | out_of_window

    p2b = torch.where(ok, _with_empty(atlas)[flat], EMPTY)
    lflat = (local[:, 0] * bs + local[:, 1]) * bs + local[:, 2]
    point2slot = torch.where(p2b >= 0, p2b * bvol + lflat, EMPTY)

    # Every point with a kept brick row is valid and in window, so its slot
    # is set to 1; all others land in the dump row.
    pb = torch.where(p2b >= 0, p2b, brick_capacity).long()
    tcl = t_idx.clamp(0, num_time - 1).long()
    occ = torch.zeros((brick_capacity + 1) * bvol * num_time, dtype=torch.float32, device=dev)
    occ.index_fill_(0, (pb * bvol + lflat.long()) * num_time + tcl, 1.0)  # no host sync
    occ = occ[: brick_capacity * bvol * num_time].reshape(brick_capacity, bs, bs, bs, num_time)
    # Occupancy is kept in bf16 (values are exactly 0/1), as in sps_tpu.
    occ = occ.to(torch.bfloat16)

    grid = AtlasGrid(coords=coords_c, occ=occ, num_bricks=num, atlas=atlas,
                     origin=origin, overflow=overflow, extent=tuple(extent))
    if features is None:
        return grid, point2slot
    # Counts and sums per (brick, voxel, t) slot in flat buffers (points
    # without a kept brick row add zeros to the dump row), then the mean.
    c = features.shape[-1]
    slot = (pb * bvol + lflat.long()) * num_time + tcl
    w = ok.to(features.dtype)
    nslot = (brick_capacity + 1) * bvol * num_time
    cnt = torch.zeros(nslot, dtype=features.dtype, device=dev).index_add_(0, slot, w)
    sums = torch.zeros((nslot, c), dtype=features.dtype, device=dev).index_add_(
        0, slot, features * w[:, None])
    nreal = brick_capacity * bvol * num_time
    pooled = sums[:nreal] / torch.clamp_min(cnt[:nreal], 1.0)[:, None]
    return grid, point2slot, pooled.reshape(brick_capacity, bs, bs, bs, num_time * c)


def downsample(grid: AtlasGrid, coarse_capacity: int, coarse_extent: tuple):
    """Coarse-level atlas grid (brick coords halve; the stride-2 output
    coordinate set). Returns (coarse_grid, fine2coarse)."""
    bcap = grid.coords.shape[0]
    bs = grid.occ.shape[1]
    dev = grid.coords.device
    valid = torch.arange(bcap, device=dev) < grid.num_bricks
    fb = grid.coords[:, 1:] >> 1
    fbatch = torch.where(valid, grid.coords[:, 0], -1)
    corigin = grid.origin >> 1
    ncell = _ncell(coarse_extent)
    flat, inb = _cells(fbatch, fb, corigin, coarse_extent)
    ok = valid & inb
    occ_cells = _occupied_cells(flat, ok, ncell)
    atlas, coords_c, num, overflow = _compact(
        occ_cells, coarse_capacity, coarse_extent, corigin, src_cells=flat, src_ok=ok
    )
    f2c = torch.where(ok, _with_empty(atlas)[flat], EMPTY)
    cgrid = AtlasGrid(
        coords=coords_c,
        occ=torch.zeros((coarse_capacity, bs, bs, bs, grid.occ.shape[-1]),
                        dtype=torch.bfloat16, device=dev),
        num_bricks=num, atlas=atlas, origin=corigin, overflow=overflow,
        extent=tuple(coarse_extent),
    )
    return cgrid, f2c


def neighbor_table(grid: AtlasGrid, offsets) -> torch.Tensor:
    """(K, Bcap) neighbour brick rows for static offsets: one dense gather."""
    bcap = grid.coords.shape[0]
    k = len(offsets)
    dev = grid.coords.device
    valid = torch.arange(bcap, device=dev) < grid.num_bricks
    batch = torch.where(valid, grid.coords[:, 0], -1)
    offs = int_table(offsets, dev)
    q = (grid.coords[None, :, 1:] + offs[:, None, :]).reshape(-1, 3)
    b = batch[None, :].expand(k, bcap).reshape(-1)
    return atlas_rows(grid, b, q).reshape(k, bcap)


def level_extents(extent: tuple, num_levels: int) -> list[tuple]:
    """Static per-level atlas extents: halve (+1 for origin-floor slack) per
    stride doubling."""
    exts = [tuple(extent)]
    for _ in range(num_levels - 1):
        nb, nx, ny, nz = exts[-1]
        exts.append((nb, (nx >> 1) + 1, (ny >> 1) + 1, (nz >> 1) + 1))
    return exts


@dataclasses.dataclass
class RowGrid:
    """Compact voxel-row view of a deep level (see RowLevel)."""

    occ: torch.Tensor  # (V, T)
    num_rows: torch.Tensor  # ()
    overflow: torch.Tensor  # ()

    def _replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class RowLevel:
    """Voxel-row topology for a deep pyramid level.

    Index domains: nbr27[k, v] -> row in this level; child[k, c] -> row in
    the finer level, or flat brick slot (brick_row * bs^3 + local) if the
    finer level is brick-form; parent[v] -> row in the coarser level (with
    parity[v]). `aliased` marks the rows of alias_row_levels (row i of level
    li is brick i of level li - 3), the only row form refresh_occupancy
    takes. The ghost_* lists are set by parallel/spatial.py's ghost mode
    (see brick.BrickLevel)."""

    grid: RowGrid
    nbr27: torch.Tensor  # (27, V)
    brick_of_row: torch.Tensor  # (V,)
    lflat_of_row: torch.Tensor  # (V,)
    child: torch.Tensor | None = None  # (8, V)
    parent: torch.Tensor | None = None  # (V,)
    parity: torch.Tensor | None = None  # (V,)
    ghost_self: torch.Tensor | None = None  # (G,) for nbr27
    ghost_child: torch.Tensor | None = None  # (G,) for child
    ghost_parent: torch.Tensor | None = None  # (G,) for parent
    aliased: bool = False

    def _replace(self, **kw):
        return dataclasses.replace(self, **kw)


def _row_compact(occ_any_flat: torch.Tensor, capacity: int):
    """(S,) slot occupancy -> (rowmap (S+1,), slot_of_row (V,), num, overflow):
    rowmap[s] = compact row or EMPTY (one trailing EMPTY); slot_of_row
    inverts it over the first `num` rows (0 beyond)."""
    s = occ_any_flat.shape[0]
    dev = occ_any_flat.device
    flag = occ_any_flat > 0
    pref = _prefix_rows(flag)
    num = flag.sum(dtype=torch.int32)
    overflow = num > capacity
    rows = torch.where(flag & (pref < capacity), pref, EMPTY)
    rowmap = _with_empty(rows)
    dest = torch.where(rows >= 0, rows, capacity).long()
    slot_of_row = torch.zeros(capacity + 1, dtype=torch.int32, device=dev)
    slot_of_row[dest] = torch.arange(s, dtype=torch.int32, device=dev)
    return rowmap, slot_of_row[:capacity], torch.clamp_max(num, capacity), overflow


def alias_row_levels(levels: list, num_levels: int) -> list:
    """RowLevels for levels >= len(levels), aliased to shallow brick levels.

    For side-8 bricks a level-(k+3) voxel covers exactly one level-k brick,
    so the deep level's row topology is the shallow level's brick topology:
    rows := level-k brick rows, occ := any over the brick's slots, nbr27 /
    parent / child := level k's tables verbatim. `levels` holds the brick
    levels [0, row_from) with row_from >= 3. Returns the full pyramid."""
    row_from = len(levels)
    assert row_from >= 3, "aliasing needs level k-3 to exist as bricks"
    assert levels[0].grid.occ.shape[1] == 8, "aliasing is a side-8 identity"
    out: list = list(levels)
    dev = levels[0].nbr27.device
    octs = int_table(bk.OCT_OFFSETS, dev)

    for li in range(row_from, num_levels):
        k = li - 3
        src = levels[k]
        bcap = src.grid.occ.shape[0]
        occ_rows = src.grid.occ.amax(dim=(1, 2, 3))  # (B, T)
        if li == row_from:
            # The 2^3 stride-halved voxels of row i sit in brick
            # grandparent^2(i) (level li-1) at local octant
            # 4*oct(k+1) + 2*oct(k) + delta per axis.
            p1 = src.parent
            l1 = levels[k + 1]
            p1c = p1.clamp(min=0).long()
            gp = torch.where(p1 >= 0, l1.parent[p1c], EMPTY)
            o1 = l1.oct[p1c]
            base = o1 * 4 + src.oct * 2  # (B, 3)
            loc = base[None, :, :] + octs[:, None, :]  # (8, B, 3)
            fl = (loc[..., 0] * 8 + loc[..., 1]) * 8 + loc[..., 2]
            child = torch.where(gp[None, :] >= 0, gp[None, :] * 512 + fl, EMPTY)
        else:
            child = src.child  # fine rows are level k-1's brick rows
        last = li + 1 >= num_levels
        parity = None if last else (src.oct[:, 0] * 2 + src.oct[:, 1]) * 2 + src.oct[:, 2]
        out.append(
            RowLevel(
                grid=RowGrid(occ=occ_rows, num_rows=src.grid.num_bricks,
                             overflow=src.grid.overflow),
                nbr27=src.nbr27,
                brick_of_row=torch.arange(bcap, dtype=torch.int32, device=dev),
                lflat_of_row=torch.zeros(bcap, dtype=torch.int32, device=dev),
                child=child,
                parent=None if last else src.parent,
                parity=parity,
                aliased=True,
            )
        )

    # Boundary: the fine brick level (row_from-1) needs the (4,4,4) block of
    # first-row-level rows covering each brick, for its transpose conv:
    # chain two child tables (level f -> f-1 -> f-2), interleave octants.
    f = row_from - 1
    fb = levels[f]
    bcap_f = fb.grid.occ.shape[0]
    c1 = levels[f].child  # (8, Bf) -> level f-1 rows
    c0 = levels[f - 1].child  # (8, Bf-1) -> level f-2 rows
    g = torch.where(c1[None, :, :] >= 0, c0[:, c1.clamp(min=0).long()], EMPTY)
    # g[j0, j1, b]: delta = 2*oct(j1) + oct(j0) per axis, OCT x-slowest.
    g = g.reshape(2, 2, 2, 2, 2, 2, bcap_f)  # (a0, b0, c0, a1, b1, c1, B)
    parent_rows = g.permute(6, 3, 0, 4, 1, 5, 2).reshape(bcap_f, 4, 4, 4)
    out[f] = fb._replace(parent_rows=parent_rows)
    return out


def hybridize_levels(levels: list, row_from: int, row_caps: tuple) -> list:
    """Convert levels[row_from:] of a brick pyramid to RowLevels (any brick
    side), wiring the strided maps across the representation boundary.

    Each row level compacts the level's occupied (brick, voxel) slots into
    at most row_caps[li] rows (overflow OR'd into the level's flag); its
    27-neighbour table resolves through the brick 27-table (a voxel offset
    of +-1 crosses at most one brick face per axis) and the slot -> row map.
    Returns [BrickLevel, ..., RowLevel, ...]; the boundary brick level
    (row_from - 1) gains `parent_rows` (Bf, bs/2, bs/2, bs/2), the coarse
    row ids of its parent-voxel block, for its transpose conv."""
    n = len(levels)
    assert 1 <= row_from < n
    out: list = list(levels)
    dev = levels[0].nbr27.device
    offs = int_table(bk.OFFS27, dev)  # (27, 3)
    rowmaps: dict = {}
    rowlvls: dict = {}

    for li in range(row_from, n):
        bl = levels[li]
        occ_b = bl.grid.occ
        bcap, bs = occ_b.shape[0], occ_b.shape[1]
        bvol = bs**3
        s = bcap * bvol
        capacity = row_caps[li]
        occ_flat = occ_b.reshape(s, occ_b.shape[-1])
        rowmap, slot_of_row, num, overflow = _row_compact(occ_flat.amax(dim=-1), capacity)
        brick_of_row = slot_of_row // bvol
        lflat_of_row = slot_of_row % bvol
        valid_rows = torch.arange(capacity, device=dev) < num
        occ_rows = take_rows(occ_flat, slot_of_row) * valid_rows[:, None].to(occ_flat.dtype)
        lx = lflat_of_row // (bs * bs)
        ly = (lflat_of_row // bs) % bs
        lz = lflat_of_row % bs
        # All 27 offsets through two grouped gathers: the brick table, then
        # the slot -> row map.
        n3 = torch.stack([lx, ly, lz])[None, :, :] + offs[:, :, None]  # (27, 3, cap)
        c3 = torch.clamp(n3, -1, bs) // bs
        kidx = ((c3[:, 0] + 1) * 3 + (c3[:, 1] + 1)) * 3 + (c3[:, 2] + 1)
        bidx = (kidx * bcap + brick_of_row[None, :]).reshape(-1)
        nbrick = bl.nbr27.reshape(-1)[bidx.long()].reshape(27, capacity)
        nlm = n3 & (bs - 1)
        nl = (nlm[:, 0] * bs + nlm[:, 1]) * bs + nlm[:, 2]
        slot = torch.where(nbrick >= 0, nbrick * bvol + nl, s)
        nbr27 = rowmap[torch.clamp_max(slot, s).reshape(-1).long()].reshape(27, capacity)
        nbr27 = torch.where(valid_rows[None, :], nbr27, EMPTY)
        child = _hybrid_child(bl, levels[li - 1], brick_of_row, lx, ly, lz, bs,
                              rowmaps.get(li - 1), valid_rows)
        rowlvls[li] = RowLevel(
            grid=RowGrid(occ=occ_rows, num_rows=num, overflow=bl.grid.overflow | overflow),
            nbr27=nbr27, brick_of_row=brick_of_row, lflat_of_row=lflat_of_row, child=child)
        rowmaps[li] = rowmap

    # parent / parity links (fine row level -> coarse row level): fine voxel
    # u = bs * b + l sits under parent voxel floor(u / 2), in brick parent[b]
    # at local (bs/2) * oct + (l >> 1).
    for li in range(row_from, n - 1):
        rl, bl = rowlvls[li], levels[li]
        bs = bl.grid.occ.shape[1]
        hs = bs // 2
        b = rl.brick_of_row.clamp(min=0).long()
        pbrick, octf = bl.parent[b], bl.oct[b]
        lx = rl.lflat_of_row // (bs * bs)
        ly = (rl.lflat_of_row // bs) % bs
        lz = rl.lflat_of_row % bs
        pl = ((octf[:, 0] * hs + (lx >> 1)) * bs + octf[:, 1] * hs + (ly >> 1)) * bs + (
            octf[:, 2] * hs + (lz >> 1))
        cs = levels[li + 1].grid.occ.shape[0] * bs**3
        pslot = torch.where(pbrick >= 0, pbrick * bs**3 + pl, cs)
        parity = ((lx & 1) * 2 + (ly & 1)) * 2 + (lz & 1)
        rowlvls[li] = rl._replace(parent=rowmaps[li + 1][torch.clamp_max(pslot, cs).long()],
                                  parity=parity)

    # Boundary: coarse row ids of each fine brick's (bs/2)^3 parent-voxel block.
    fb = levels[row_from - 1]
    bs = fb.grid.occ.shape[1]
    hs = bs // 2
    cs = levels[row_from].grid.occ.shape[0] * bs**3
    ax = torch.arange(hs, dtype=torch.int32, device=dev)
    plx = fb.oct[:, 0, None, None, None] * hs + ax[None, :, None, None]
    ply = fb.oct[:, 1, None, None, None] * hs + ax[None, None, :, None]
    plz = fb.oct[:, 2, None, None, None] * hs + ax[None, None, None, :]
    pl = (plx * bs + ply) * bs + plz  # (Bf, hs, hs, hs)
    pbrick = fb.parent[:, None, None, None]
    pslot = torch.where(pbrick >= 0, pbrick * bs**3 + pl, cs)
    out[row_from - 1] = fb._replace(parent_rows=rowmaps[row_from][torch.clamp_max(pslot, cs).long()])
    for li in range(row_from, n):
        out[li] = rowlvls[li]
    return out


def _hybrid_child(bl, fine_bl, brick_of_row, lx, ly, lz, bs: int, fine_rowmap, valid_rows):
    """(8, V) down-conv sources of a row level: fine row ids where the finer
    level is rows (fine_rowmap given), else flat fine brick slots."""
    bcap = bl.grid.occ.shape[0]
    bvol = bs**3
    fs = fine_bl.grid.occ.shape[0] * bvol
    cap = brick_of_row.shape[0]
    # All 8 octants through two grouped gathers: the child table, then the rowmap.
    octs = int_table(bk.OCT_OFFSETS, brick_of_row.device)  # (8, 3)
    f3 = 2 * torch.stack([lx, ly, lz])[None, :, :] + octs[:, :, None]  # (8, 3, cap)
    kflat = ((f3[:, 0] // bs) * 2 + (f3[:, 1] // bs)) * 2 + (f3[:, 2] // bs)
    cidx = (kflat * bcap + brick_of_row[None, :]).reshape(-1)
    fbrick = bl.child.reshape(-1)[cidx.long()].reshape(8, cap)
    fm = f3 & (bs - 1)
    fl = (fm[:, 0] * bs + fm[:, 1]) * bs + fm[:, 2]
    fslot = torch.where(fbrick >= 0, fbrick * bvol + fl, fs)
    if fine_rowmap is not None:
        outs = fine_rowmap[torch.clamp_max(fslot, fs).reshape(-1).long()].reshape(8, cap)
    else:
        outs = torch.where(fslot < fs, fslot, EMPTY)
    return torch.where(valid_rows[None, :], outs, EMPTY)


def refresh_occupancy(levels: list, occ0: torch.Tensor) -> list:
    """New per-scan occupancy through a cached topology pyramid.

    Topology tables depend only on the brick set; per-slot occupancy is the
    only per-scan data, and phantom slots contribute exact zeros, so a
    refreshed pyramid scores like a rebuilt one whenever the cached set
    covers the scan. Brick levels re-derive occupancy via their child tables
    (2^3 max-pool); aliased row levels as the slot-max of brick level li-3.
    A hybridized pyramid's row levels (hybridize_levels) have no such
    identity and raise: sps_tpu's shape assertion catches them only where
    the capacities differ, and indexes them in the wrong row order where
    they coincide."""
    out = list(levels)
    occs: list = [occ0]
    out[0] = levels[0]._replace(grid=levels[0].grid._replace(occ=occ0))
    for li in range(1, len(levels)):
        lv = levels[li]
        if isinstance(lv, bk.BrickLevel):
            o = bk.coarse_occ_from_children(occs[li - 1], lv.child)
            occs.append(o)
            out[li] = lv._replace(grid=lv.grid._replace(occ=o))
            continue
        if not lv.aliased:
            raise ValueError(f"refresh_occupancy: row level {li} is not an alias_row_levels "
                             "level (a hybridized pyramid); rebuild the topology instead")
        o = occs[li - 3].amax(dim=(1, 2, 3))
        occs.append(None)
        out[li] = lv._replace(grid=lv.grid._replace(occ=o))
    return out


def build_levels(grid0: AtlasGrid, *, num_levels: int, capacities: tuple) -> list:
    """Atlas topology pyramid of brick.BrickLevel objects, finest first."""
    assert capacities[0] == grid0.coords.shape[0]
    exts = level_extents(grid0.extent, num_levels)
    grids = [grid0]
    f2c: list = []
    for li in range(num_levels - 1):
        cg, m = downsample(grids[-1], capacities[li + 1], exts[li + 1])
        f2c.append(m)
        grids.append(cg)

    levels: list = []
    for li, g in enumerate(grids):
        bcap = g.coords.shape[0]
        dev = g.coords.device
        nbr27 = neighbor_table(g, bk.OFFS27)
        last = li == num_levels - 1
        parent = None if last else f2c[li]
        oct_ = None if last else g.coords[:, 1:] & 1
        child = None
        if li > 0:
            # Fine brick bf with octant o is the (o, f2c[bf]) child: a
            # scatter of unique (octant, parent) pairs; invalid fine bricks
            # go to the dump column.
            fine = grids[li - 1]
            bf = fine.coords.shape[0]
            validf = torch.arange(bf, device=dev) < fine.num_bricks
            octf = fine.coords[:, 1:] & 1
            kflat = octf[:, 0] * 4 + octf[:, 1] * 2 + octf[:, 2]
            fc = f2c[li - 1]
            dest = torch.where(validf & (fc >= 0), fc, bcap)
            child = torch.full((8, bcap + 1), EMPTY, dtype=torch.int32, device=dev)
            child[kflat.long(), dest.long()] = torch.arange(bf, dtype=torch.int32, device=dev)
            child = child[:, :bcap]
            g = g._replace(occ=bk.coarse_occ_from_children(fine.occ, child))
            grids[li] = g
        levels.append(bk.BrickLevel(grid=g, nbr27=nbr27, parent=parent, oct=oct_, child=child))
    return levels
