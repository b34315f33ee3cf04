"""Spatial sharding (sp): every pyramid level's brick (or voxel-row) axis is
partitioned into contiguous blocks across the ranks of the "sp" axis
(counterpart of sps_tpu/parallel/spatial.py).

The topology build (voxelize, the atlas pyramid) runs replicated on every
rank: it is index-only and a small part of a scan. `slice_levels` then cuts
each level's output-domain tables (occupancy, nbr27 columns, parent / child
maps) to the rank's block; activations flow between convs as local blocks,
and each conv assembles its gather source:

  * ghost_frac = 0: the tiled all-gather of the input level (table values
    stay global row ids);
  * ghost_frac > 0: the ghost exchange. The atlas orders brick rows by cell
    (batch-major, then x), so a block is a spatial slab and the rows it
    references outside itself are the slab's surface. slice_levels compacts
    those global ids into a static-capacity ghost list per (level, table),
    remaps the table into [local | ghost] ids, and the conv fetches the
    ghost rows with one all-to-all (`exchange`). Ghost capacity overflow is
    OR'd into the level's overflow flag: reported, never silent.

The local block stays the conv's centre (brick.halo's `center`). BatchNorm
in training sums its masked moments over the axis; the UNet's output is
all-gathered before devoxelizing, so every rank returns the same scores.
"""

from __future__ import annotations

import dataclasses

import torch

from sps_torch.ops import atlas as atl
from sps_torch.ops import brick as bk
from sps_torch.ops.voxelize import EMPTY
from sps_torch.parallel import comm

# Ghost lists are rounded up to a multiple of this many rows (sps_tpu's).
GHOST_ROUND = 64


def _axis_block(n_rows: int, rank: int, n: int) -> tuple[int, int]:
    """(start, size) of rank's contiguous block of n_rows rows."""
    if n_rows % n:
        raise ValueError(f"capacity {n_rows} not divisible by sp axis size {n}; pick "
                         "capacities divisible by the mesh dimension")
    blk = n_rows // n
    return rank * blk, blk


def _s0(x, rank: int, n: int):
    if x is None:
        return None
    start, blk = _axis_block(x.shape[0], rank, n)
    return x[start : start + blk]


def _s1(x, rank: int, n: int):
    """Columns of a (K, rows) table, contiguous (the int8 gather kernel reads
    nbr27 as it is)."""
    if x is None:
        return None
    start, blk = _axis_block(x.shape[1], rank, n)
    return x[:, start : start + blk].contiguous()


def _ghost_plan(tables, src_cap: int, rank: int, n: int, ghost_cap: int):
    """Ghost plan of a source domain of src_cap rows.

    tables: (table, divisor) pairs whose values are global source rows (a
    divisor > 1 where values are flat sub-slots row * divisor + local, the
    first row level's brick-slot children). Marks every value outside this
    rank's block, compacts the marked rows into at most ghost_cap ghost
    slots, and remaps each table into [0, blk) local | [blk, blk + ghost_cap)
    ghost ids. Returns (remapped tables, ghost ids (ghost_cap,), overflow)."""
    lo, blk = _axis_block(src_cap, rank, n)
    dev = tables[0][0].device
    mark = torch.zeros(src_cap + 1, dtype=torch.int32, device=dev)
    infos = []
    for t, div in tables:
        ids = t // div if div > 1 else t
        valid = t >= 0
        remote = valid & ((ids < lo) | (ids >= lo + blk))
        mark.index_fill_(0, torch.where(remote, ids, src_cap).reshape(-1).long(), 1)
        infos.append((t, div, ids, valid, remote))
    rowmap, ghost_ids, _, overflow = atl._row_compact(mark[:src_cap], ghost_cap)
    remapped = []
    for t, div, ids, valid, remote in infos:
        slot = rowmap[ids.clamp(0, src_cap).long()]
        base = torch.where(remote, blk + slot, ids - lo)
        new_t = base * div + t % div if div > 1 else base
        # An overflowed ghost has no slot: drop the entry (overflow says so)
        # rather than alias a local row.
        ok = valid & torch.where(remote, slot >= 0, True)
        remapped.append(torch.where(ok, new_t, EMPTY))
    return remapped, ghost_ids, overflow


def exchange(x_local: torch.Tensor, ghost_ids: torch.Tensor, axis: str) -> torch.Tensor:
    """(blk, ...) local block and (G,) global ghost rows -> (blk + G, ...)
    [local | ghosts]: the ghost ids all-gathered, each rank sending the rows
    of its block that the others need in one all-to-all (zeros elsewhere),
    every ghost summed from its one owner."""
    blk, g = x_local.shape[0], ghost_ids.shape[0]
    lo = comm.rank(axis) * blk
    ids_all = comm.all_gather(ghost_ids[None], axis)  # (n, G)
    rel = ids_all - lo
    mine = (rel >= 0) & (rel < blk)
    flat = x_local.reshape(blk, -1)
    send = torch.where(mine[..., None], flat[rel.clamp(0, blk - 1).long()], 0)
    ghosts = comm.all_to_all(send, axis).sum(0)
    return torch.cat([x_local, ghosts.reshape((g,) + tuple(x_local.shape[1:]))])


def gather_source(feats: torch.Tensor, lvl, kind: str, axis: str) -> torch.Tensor:
    """A conv's gather source under sp: the ghost exchange where the level
    has a plan for this table ("self", "child" or "parent"), else the
    all-gathered level."""
    ids = getattr(lvl, f"ghost_{kind}", None)
    if ids is not None:
        return exchange(feats, ids, axis)
    return comm.all_gather(feats, axis)


def slice_levels(levels: list, axis: str, ghost_frac: float = 0.0) -> list:
    """This rank's view of a replicated pyramid: each level's output-domain
    tables cut to the rank's block of rows; with ghost_frac > 0 also the
    ghost plans (capacity ghost_frac * block per source domain, rounded up
    to GHOST_ROUND)."""
    return slice_rank(levels, comm.rank(axis), comm.size(axis), ghost_frac)


def slice_rank(levels: list, rank: int, n: int, ghost_frac: float = 0.0) -> list:
    """slice_levels for rank `rank` of n, without a process group."""
    if ghost_frac > 0.0:
        return _slice_levels_ghost(levels, rank, n, ghost_frac)
    out = []
    for lv in levels:
        if isinstance(lv, atl.RowLevel):
            out.append(lv._replace(
                grid=lv.grid._replace(occ=_s0(lv.grid.occ, rank, n)),
                nbr27=_s1(lv.nbr27, rank, n),
                brick_of_row=_s0(lv.brick_of_row, rank, n),
                lflat_of_row=_s0(lv.lflat_of_row, rank, n),
                child=_s1(lv.child, rank, n), parent=_s0(lv.parent, rank, n),
                parity=_s0(lv.parity, rank, n)))
        elif isinstance(lv, bk.BrickLevel):
            g = lv.grid
            out.append(lv._replace(
                grid=g._replace(occ=_s0(g.occ, rank, n), coords=_s0(g.coords, rank, n)),
                nbr27=_s1(lv.nbr27, rank, n), parent=_s0(lv.parent, rank, n),
                oct=_s0(lv.oct, rank, n), child=_s1(lv.child, rank, n),
                parent_rows=_s0(lv.parent_rows, rank, n)))
        else:  # a gather-engine level (ops.topology.Level)
            g = lv.grid
            out.append(lv._replace(
                grid=g._replace(occ=_s0(g.occ, rank, n), coords=_s0(g.coords, rank, n)),
                nbr={k: _s1(v, rank, n) for k, v in lv.nbr.items()},
                child=_s1(lv.child, rank, n), parent=_s0(lv.parent, rank, n),
                parity=_s0(lv.parity, rank, n)))
    return out


def ghost_capacity(src_cap: int, n: int, frac: float) -> int:
    """Ghost rows of a source domain: frac * block rounded up to GHOST_ROUND,
    at least GHOST_ROUND, at most the other ranks' rows."""
    blk = src_cap // n
    return min(blk * (n - 1), max(GHOST_ROUND, -(-int(blk * frac) // GHOST_ROUND) * GHOST_ROUND))


def _slice_levels_ghost(levels: list, rank: int, n: int, frac: float) -> list:
    """slice_levels with ghost plans: output-domain tables sliced, then their
    values remapped into [local | ghost] ids, one plan per source domain."""
    if not all(isinstance(lv, (atl.RowLevel, bk.BrickLevel)) for lv in levels):
        raise NotImplementedError("the ghost exchange takes brick and voxel-row levels "
                                  "(atlas and brick engines), as sps_tpu's")

    def src_cap(i: int) -> int:
        return levels[i].grid.occ.shape[0]

    def plan(table, div, i):
        [t], ghosts, ov = _ghost_plan([(table, div)], src_cap(i), rank, n,
                                      ghost_capacity(src_cap(i), n, frac))
        return t, ghosts, ov

    out: list = []
    for li, lv in enumerate(levels):
        is_row = isinstance(lv, atl.RowLevel)
        over = lv.grid.overflow
        nbr, g_self, ov = plan(_s1(lv.nbr27, rank, n), 1, li)
        over = over | ov
        child, g_child = _s1(lv.child, rank, n), None
        if child is not None:
            prev = levels[li - 1]
            # The first row level's children are flat slots of the brick level.
            div = prev.grid.occ.shape[1] ** 3 if is_row and isinstance(prev, bk.BrickLevel) else 1
            child, g_child, ov = plan(child, div, li - 1)
            over = over | ov
        parent, g_parent = _s0(lv.parent, rank, n), None
        if parent is not None:
            parent, g_parent, ov = plan(parent, 1, li + 1)
            over = over | ov
        if is_row:
            out.append(lv._replace(
                grid=lv.grid._replace(occ=_s0(lv.grid.occ, rank, n), overflow=over),
                nbr27=nbr, brick_of_row=_s0(lv.brick_of_row, rank, n),
                lflat_of_row=_s0(lv.lflat_of_row, rank, n), child=child, parent=parent,
                parity=_s0(lv.parity, rank, n), ghost_self=g_self, ghost_child=g_child,
                ghost_parent=g_parent))
            continue
        parent_rows = _s0(lv.parent_rows, rank, n)
        if parent_rows is not None:
            # The boundary transpose conv: coarse row ids of the next level,
            # on the parent plan's slot.
            assert parent is None, "parent and parent_rows both set"
            parent_rows, g_parent, ov = plan(parent_rows, 1, li + 1)
            over = over | ov
        g = lv.grid
        out.append(lv._replace(
            grid=g._replace(occ=_s0(g.occ, rank, n), coords=_s0(g.coords, rank, n),
                            overflow=over),
            nbr27=nbr, parent=parent, oct=_s0(lv.oct, rank, n), child=child,
            parent_rows=parent_rows, ghost_self=g_self, ghost_child=g_child,
            ghost_parent=g_parent))
    return out


def sp_config(scfg, axis: str = "sp", ghost_frac: float = 0.0):
    """An SPSConfig whose UNet runs spatially sharded over `axis`; ghost_frac
    > 0 assembles conv sources by the ghost exchange."""
    return dataclasses.replace(
        scfg, unet=dataclasses.replace(scfg.unet, sp_axis=axis, sp_ghost_frac=ghost_frac))
