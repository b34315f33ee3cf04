"""Dense-brick sparse engine (counterpart of sps_tpu/ops/brick.py).

Voxels live in bs^3 bricks; a stride-1 sparse conv becomes a dense conv
over halo-extended bricks assembled from the 26 neighbour bricks given by
`nbr27` ("halo"), or, for 3^3 kernels, a SAME conv within each brick plus
one small conv per neighbour region ("region"). The brick engine's own
topology (`voxelize_bricks`, `build_brick_levels`) dedups and looks up
bricks through the hash table of ops/hash.py; the atlas engine
(ops/atlas.py) builds the same BrickLevel tables without probing. Empty voxels inside occupied bricks are phantom slots, masked to
exact zeros by the brick occupancy (B, bs, bs, bs, T). The z-band layout
folds z into channels, (B, bs, bs, bs*TC), and runs the stride-1 conv as
one 2-D conv (ops/zband_conv.py, a CUDA kernel on the card).

The halo assembly's gradient is a gather too (`_halo_transpose`, sps_tpu's
`_halo_bwd_core` in the port's gather layout): autograd's own transpose of
a row gather is an atomic scatter-add, non-deterministic in float.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from sps_torch.ops import brick_conv_int8 as bi8
from sps_torch.ops import hash as vhash
from sps_torch.ops import voxelize as vox
from sps_torch.ops import zband_conv as zc
from sps_torch.ops.sparse_conv import mask_slots, pack_time_toeplitz, take_rows

# x-slowest (0,1)^3 enumeration.
OCT_OFFSETS = [(a, b, c) for a in (0, 1) for b in (0, 1) for c in (0, 1)]
OFFS27 = [(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1) for c in (-1, 0, 1)]


class BrickGrid(NamedTuple):
    """Brick grid of the brick engine, its lookup structure a hash table."""

    coords: torch.Tensor  # (B, 4) int32 [batch, bx, by, bz]; PAD_COORD beyond num
    occ: torch.Tensor  # (B, bs, bs, bs, T) float32
    num_bricks: torch.Tensor  # () int32
    table: vhash.HashTable  # brick coords -> compact row
    overflow: torch.Tensor  # () bool


class BrickLevel(NamedTuple):
    grid: object  # BrickGrid or atlas.AtlasGrid
    nbr27: torch.Tensor  # (27, B) neighbour brick rows (OFFS27 order)
    parent: torch.Tensor | None  # (B,) coarse brick row
    oct: torch.Tensor | None  # (B, 3) octant (bcoords & 1) per axis
    child: torch.Tensor | None  # (8, B) fine brick rows (OCT_OFFSETS order)
    # Coarse ROW ids of this level's (bs/2)^3 parent-voxel block, set on the
    # fine level just below the brick->row boundary (atlas.alias_row_levels,
    # atlas.hybridize_levels).
    parent_rows: torch.Tensor | None = None
    # Spatial sharding, ghost mode (parallel/spatial.py): the global source
    # rows this shard needs from other shards, per table. When set, the
    # table (nbr27 / child / parent or parent_rows) holds [local | ghost]
    # ids and the conv fetches the ghosts with one all-to-all.
    ghost_self: torch.Tensor | None = None  # (G,) for nbr27
    ghost_child: torch.Tensor | None = None  # (G,) for child (the finer level)
    ghost_parent: torch.Tensor | None = None  # (G,) for parent / parent_rows


def _assemble_octants(blocks: torch.Tensor) -> torch.Tensor:
    """(8, B, s, s, s, C) octant blocks in OCT_OFFSETS order -> (B, 2s, 2s, 2s, C)."""
    _, b, s, _, _, c = blocks.shape
    x = blocks.reshape(2, 2, 2, b, s, s, s, c).permute(3, 0, 4, 1, 5, 2, 6, 7)
    return x.reshape(b, 2 * s, 2 * s, 2 * s, c)


def gather_children(fine_vals: torch.Tensor, child: torch.Tensor) -> torch.Tensor:
    """(Bc, 2bs, 2bs, 2bs, C) blocks from (8, Bc) child rows over (Bf, bs, bs, bs, C)
    fine values (zeros where absent)."""
    bf = fine_vals.shape[0]
    flat = fine_vals.reshape(bf, -1)
    blocks = take_rows(flat, child).reshape(child.shape + fine_vals.shape[1:])
    return _assemble_octants(blocks)


def coarse_occ_from_children(fine_occ: torch.Tensor, child: torch.Tensor) -> torch.Tensor:
    """(Bc, bs, bs, bs, T) coarse occupancy = OR over the 2^3 fine windows."""
    t = fine_occ.shape[-1]
    bs = fine_occ.shape[1]
    big = gather_children(fine_occ, child)
    bc = big.shape[0]
    return big.reshape(bc, bs, 2, bs, 2, bs, 2, t).amax(dim=(2, 4, 6))


def voxelize_bricks(coords, batch_idx, t_idx, valid, *, num_time: int, brick_capacity: int,
                    features=None, brick_side: int = 4):
    """Dedup (N, 3) int32 voxel coords into bricks through the hash table.

    Returns (grid, point2slot[, pooled]): point2slot the flat index
    brick_row * bs^3 + local into the (B*bs^3,) slot view (EMPTY if
    invalid); with `features` (N, C) also the (B, bs, bs, bs, T*C) per-slot
    mean of the features (ME's UNWEIGHTED_AVERAGE)."""
    bs = brick_side
    assert bs & (bs - 1) == 0 and bs >= 2, "brick side must be a power of two"
    shift = bs.bit_length() - 1
    bvol = bs**3
    n = coords.shape[0]
    dev = coords.device
    local = coords & (bs - 1)
    key = torch.cat([batch_idx[:, None].to(torch.int32), (coords >> shift).to(torch.int32)], -1)
    raw, slot_of = vhash.build(key, valid, vhash.next_pow2(max(2 * n, 16)))
    row_of_slot, coords_c, table, num, overflow = vox.compact_slots(raw, brick_capacity)
    p2b = vox.row_of_points(row_of_slot, slot_of, valid, brick_capacity)
    lflat = (local[:, 0] * bs + local[:, 1]) * bs + local[:, 2]
    point2slot = torch.where(p2b >= 0, p2b * bvol + lflat, vhash.EMPTY)

    # Every point with a brick row is valid, so its slot is set to 1; all
    # others land in the dump brick.
    pb = torch.where(p2b >= 0, p2b, brick_capacity).long()
    tcl = t_idx.clamp(0, num_time - 1).long()
    slot = (pb * bvol + lflat.long()) * num_time + tcl
    occ = torch.zeros((brick_capacity + 1) * bvol * num_time, dtype=torch.float32, device=dev)
    occ.index_fill_(0, slot, 1.0)
    nreal = brick_capacity * bvol * num_time
    occ = occ[:nreal].reshape(brick_capacity, bs, bs, bs, num_time)
    grid = BrickGrid(coords=coords_c, occ=occ, num_bricks=num, table=table, overflow=overflow)
    if features is None:
        return grid, point2slot
    c = features.shape[-1]
    w = valid.to(features.dtype)
    nslot = (brick_capacity + 1) * bvol * num_time
    cnt = torch.zeros(nslot, dtype=features.dtype, device=dev).index_add_(0, slot, w)
    sums = torch.zeros((nslot, c), dtype=features.dtype, device=dev).index_add_(
        0, slot, features * w[:, None])
    pooled = sums[:nreal] / torch.clamp_min(cnt[:nreal], 1.0)[:, None]
    return grid, point2slot, pooled.reshape(brick_capacity, bs, bs, bs, num_time * c)


def invert_rows(rows: torch.Tensor, size: int) -> torch.Tensor:
    """Invert injective row maps: out[..., j] = i where rows[..., i] == j
    (EMPTY elsewhere). Mirror-offset neighbour tables follow from their
    opposite offset's (j is i's neighbour at d iff i is j's at -d)."""
    lead, n = rows.shape[:-1], rows.shape[-1]
    src = torch.arange(n, dtype=torch.int32, device=rows.device).expand(lead + (n,))
    dest = torch.where(rows >= 0, rows, size).long()
    out = torch.full(lead + (size + 1,), vhash.EMPTY, dtype=torch.int32, device=rows.device)
    return out.scatter_(-1, dest, src)[..., :size]


def _brick_lookup(grid: BrickGrid, offsets) -> torch.Tensor:
    """(K, B) neighbour brick rows for static brick-coordinate offsets: one
    hash lookup of K * B queries."""
    b = grid.coords.shape[0]
    dev = grid.coords.device
    offs = vox.int_table(offsets, dev)
    k = offs.shape[0]
    valid = torch.arange(b, device=dev) < grid.num_bricks
    q = torch.cat([grid.coords[None, :, :1].expand(k, b, 1),
                   grid.coords[None, :, 1:] + offs[:, None, :]], -1).reshape(k * b, 4)
    qv = valid[None, :].expand(k, b).reshape(-1)
    return vhash.lookup(grid.table, q, qv).reshape(k, b)


def downsample_bricks(grid: BrickGrid, coarse_capacity: int) -> tuple[BrickGrid, torch.Tensor]:
    """Coarse-level brick grid (the voxel stride doubles, so brick coords
    halve) and fine2coarse. Rows past num_bricks are keyed PAD_COORD; the
    coarse occupancy (zeros here) comes from the children."""
    b = grid.coords.shape[0]
    dev = grid.coords.device
    valid = torch.arange(b, device=dev) < grid.num_bricks
    ckey = torch.cat([grid.coords[:, :1], grid.coords[:, 1:] >> 1], -1)
    ckey = torch.where(valid[:, None], ckey, vox.PAD_COORD)
    raw, slot_of = vhash.build(ckey, valid, vhash.next_pow2(max(2 * b, 16)))
    row_of_slot, coords_c, table, num, overflow = vox.compact_slots(raw, coarse_capacity)
    f2c = vox.row_of_points(row_of_slot, slot_of, valid, coarse_capacity)
    bs, t = grid.occ.shape[1], grid.occ.shape[-1]
    cgrid = BrickGrid(coords=coords_c,
                      occ=torch.zeros((coarse_capacity, bs, bs, bs, t), dtype=grid.occ.dtype,
                                      device=dev),
                      num_bricks=num, table=table, overflow=overflow)
    return cgrid, f2c


def build_brick_levels(grid0: BrickGrid, *, num_levels: int, capacities: tuple) -> list:
    """Brick topology pyramid of the brick engine, finest first: 13 hash
    lookups a level (the offsets before the centre), their mirrors by
    inversion, the centre as the identity; child maps by scatter from the
    downsample's assignment; coarse occupancy from the children."""
    assert capacities[0] == grid0.coords.shape[0]
    grids, f2c = [grid0], []
    for li in range(num_levels - 1):
        cg, m = downsample_bricks(grids[-1], capacities[li + 1])
        f2c.append(m)
        grids.append(cg)

    levels = []
    for li, g in enumerate(grids):
        b = g.coords.shape[0]
        dev = g.coords.device
        half = _brick_lookup(g, OFFS27[:13])
        centre = torch.where(torch.arange(b, device=dev) < g.num_bricks,
                             torch.arange(b, dtype=torch.int32, device=dev), vhash.EMPTY)
        nbr27 = torch.cat([half, centre[None], invert_rows(half, b).flip(0)])
        last = li == num_levels - 1
        child = None
        if li > 0:
            # Fine brick bf with octant o is the (o, f2c[bf]) child.
            fine = grids[li - 1]
            bf = fine.coords.shape[0]
            validf = torch.arange(bf, device=dev) < fine.num_bricks
            octf = fine.coords[:, 1:] & 1
            kflat = octf[:, 0] * 4 + octf[:, 1] * 2 + octf[:, 2]
            fc = f2c[li - 1]
            dest = torch.where(validf & (fc >= 0), fc, b)
            child = torch.full((8, b + 1), vhash.EMPTY, dtype=torch.int32, device=dev)
            child[kflat.long(), dest.long()] = torch.arange(bf, dtype=torch.int32, device=dev)
            child = child[:, :b]
            g = g._replace(occ=coarse_occ_from_children(fine.occ, child))
            grids[li] = g
        levels.append(BrickLevel(grid=g, nbr27=nbr27, parent=None if last else f2c[li],
                                 oct=None if last else g.coords[:, 1:] & 1, child=child))
    return levels


_HALO_MAPS: dict = {}


def _halo_map(bs: int, pad: int, device):
    """Static (3, h*h) tables for a halo of side h = bs + 2*pad, uploaded
    once per device. Halo column (x, y) takes its z cells from the z-lines
    of three bricks (dz = -1, 0, +1); for each dz and (x, y) the tables
    hold the OFFS27 index of that brick and the z-line (lx*bs + ly) in it."""
    key = (bs, pad, str(device))
    if key not in _HALO_MAPS:
        h = bs + 2 * pad
        d = np.arange(h) - pad
        nd = np.floor_divide(d, bs)  # -1, 0, 1: which neighbour along the axis
        loc = d - nd * bs
        dz, gx, gy = np.meshgrid(np.arange(3), np.arange(h), np.arange(h), indexing="ij")
        k = ((nd[gx] + 1) * 3 + (nd[gy] + 1)) * 3 + dz
        line = loc[gx] * bs + loc[gy]
        _HALO_MAPS[key] = (
            torch.as_tensor(k.reshape(3, -1), dtype=torch.long, device=device),
            torch.as_tensor(line.reshape(3, -1), dtype=torch.long, device=device),
        )
    return _HALO_MAPS[key]


def _halo_assemble(x, nbr27, pad, zaxis_scale, center=None):
    """Halo assembly over (B, bs, bs, Z, ...) features laid out voxel-major
    (x, y, z, then TC channels). `zaxis_scale` is 1 for (B, bs, bs, bs, TC)
    and TC for the z-folded (B, bs, bs, bs*TC) layout; the output keeps the
    input's layout. `center` (B', ...) in x's layout, when given, is the
    centre slab of the B' = nbr27.shape[1] output bricks in place of the
    rows that nbr27's centre row names (spatial sharding: x is the gather
    source, the all-gathered level or local + ghost rows, and center the
    local block).

    sps_tpu groups the 26 neighbour slabs into 3 gathers to suit the TPU;
    on the card each slice and copy is a kernel launch, so here every halo
    column (x, y) is three row gathers: the last `pad` z cells of the
    dz = -1 brick's z-line, the whole z-line of the dz = 0 brick and the
    first `pad` z cells of the dz = +1 brick, joined by one concatenation.
    Absent neighbours read a trailing zero row. The centre comes from
    nbr27's centre row like any neighbour: the input itself for occupied
    bricks, zeros beyond num_bricks, as their masked features are."""
    b, bs = x.shape[0], x.shape[1]
    assert 1 <= pad <= bs
    h = bs + 2 * pad
    bout = nbr27.shape[1]
    lines = x.reshape(b * bs * bs, -1)  # z-lines: bs * TC values each
    tc = lines.shape[1] // bs
    k, line = _halo_map(bs, pad, x.device)
    nb = nbr27[k.reshape(-1)].reshape(3, h * h, bout)
    rows = torch.where(nb >= 0, nb.long() * (bs * bs) + line[:, :, None], b * bs * bs)
    rows = rows.permute(0, 2, 1).reshape(3, -1)  # (dz, B' * h * h)
    parts = []
    for dz, src in enumerate((lines[:, (bs - pad) * tc :], lines, lines[:, : pad * tc])):
        src = torch.cat([src, src.new_zeros((1, src.shape[1]))])
        parts.append(src[rows[dz]].reshape(bout, h, h, -1))
    out = torch.cat(parts, dim=-1)
    if center is not None:
        v = out.view(bout, h, h, h, -1)
        v[:, pad : pad + bs, pad : pad + bs, pad : pad + bs] = center.reshape(
            bout, bs, bs, bs, -1)
    return out.reshape((bout, h, h, h * zaxis_scale) + tuple(x.shape[4:]))


_HALO_T_MAPS: dict = {}


def _halo_transpose_map(bs: int, pad: int, device):
    """Static tables of the halo's transpose, uploaded once per device. A
    source z-line (lx, ly) of brick s sits in the halo of each brick b with
    s = nbr27[k][b], at halo column (lx + dx*bs + pad, ly + dy*bs + pad)
    for the offset k = (dx, dy, dz), where that column lies in the halo;
    by the tables' symmetry b = nbr27[26 - k][s]. For each dz, each of J
    slots (a line has at most J such (dx, dy)) and each line, the tables
    hold 26 - k (-1 for an unused slot) and the halo column h_x * h + h_y."""
    key = (bs, pad, str(device))
    if key not in _HALO_T_MAPS:
        h = bs + 2 * pad
        loc = np.arange(bs)
        # Per axis: the offsets under which each local index lands in the halo.
        axis = [[d for d in (-1, 0, 1) if 0 <= l + d * bs + pad < h] for l in loc]
        slots = [[(dx, dy) for dx in axis[lx] for dy in axis[ly]]
                 for lx in range(bs) for ly in range(bs)]
        j = max(len(s) for s in slots)
        kt = np.full((3, j, bs * bs), -1, np.int64)
        col = np.zeros((3, j, bs * bs), np.int64)
        for line, sl in enumerate(slots):
            lx, ly = divmod(line, bs)
            for i, (dx, dy) in enumerate(sl):
                for dz in range(3):
                    kt[dz, i, line] = 26 - (((dx + 1) * 3 + dy + 1) * 3 + dz)
                    col[dz, i, line] = (lx + dx * bs + pad) * h + ly + dy * bs + pad
        _HALO_T_MAPS[key] = (torch.as_tensor(kt, device=device),
                             torch.as_tensor(col, device=device))
    return _HALO_T_MAPS[key]


def _halo_transpose(g, nbr27, pad, x_shape):
    """Gradient of _halo_assemble by gathers (no scatter): each source
    z-line collects, for each dz, the cotangent of the halo columns it
    filled, brought back through nbr27[26 - k]. g has the halo's shape;
    returns the input's gradient, of shape x_shape. Phantom rows of nbr27
    carry -1, so bricks past num_bricks, which no halo reads, get 0."""
    b, bs = x_shape[0], x_shape[1]
    h = bs + 2 * pad
    cols = g.reshape(g.shape[0] * h * h, -1)  # halo columns: h * TC values each
    tc = cols.shape[1] // h
    kt, col = _halo_transpose_map(bs, pad, g.device)
    nb = nbr27[kt.clamp(min=0).reshape(-1)].reshape(kt.shape + (b,))  # (3, J, bs*bs, B)
    rows = torch.where((nb >= 0) & (kt[..., None] >= 0), nb.long() * (h * h) + col[..., None],
                       cols.shape[0])
    rows = rows.permute(0, 1, 3, 2).reshape(3, kt.shape[1], -1)  # (dz, J, B * bs*bs)
    parts = []
    # dz = -1 filled halo z [0, pad) from source z [bs - pad, bs); dz = 0 halo
    # z [pad, pad + bs) from the whole line; dz = +1 halo z [bs + pad, h) from
    # source z [0, pad).
    for dz, src in enumerate((cols[:, : pad * tc], cols[:, pad * tc : (pad + bs) * tc],
                              cols[:, (bs + pad) * tc :])):
        src = torch.cat([src, src.new_zeros((1, src.shape[1]))])
        acc = src[rows[dz, 0]]
        for i in range(1, rows.shape[1]):
            acc = acc + src[rows[dz, i]]
        parts.append(acc)
    d = parts[1]
    d[:, (bs - pad) * tc :] += parts[0]
    d[:, : pad * tc] += parts[2]
    return d.reshape(x_shape)


class _SymmetricHalo(torch.autograd.Function):
    """The halo assembly with its gather-transpose gradient (tables of one
    level, where nbr27[k][b] == s <=> nbr27[26 - k][s] == b)."""

    @staticmethod
    def forward(ctx, x, nbr27, pad, zaxis_scale):
        ctx.save_for_backward(nbr27)
        ctx.pad, ctx.x_shape = pad, x.shape
        return _halo_assemble(x, nbr27, pad, zaxis_scale)

    @staticmethod
    def backward(ctx, g):
        (nbr27,) = ctx.saved_tensors
        return _halo_transpose(g, nbr27, ctx.pad, ctx.x_shape), None, None, None


def _halo(x, nbr27, pad, zaxis_scale, center=None):
    """sps_tpu's dispatch: the gather-transpose gradient when the output
    bricks are the input's (feats.shape[0] == nbr27.shape[1], no center),
    else autograd through the gathers."""
    if (center is None and torch.is_grad_enabled() and x.requires_grad
            and x.shape[0] == nbr27.shape[1]):
        return _SymmetricHalo.apply(x, nbr27, pad, zaxis_scale)
    return _halo_assemble(x, nbr27, pad, zaxis_scale, center)


def halo(feats: torch.Tensor, nbr27: torch.Tensor, pad: int, center=None) -> torch.Tensor:
    """(B, bs, bs, bs, C) -> (B', bs+2p, bs+2p, bs+2p, C): 26-neighbour
    assembly, B' = nbr27.shape[1]; `center` as in _halo_assemble."""
    return _halo(feats, nbr27, pad, 1, center)


def halo_z(zfeats: torch.Tensor, nbr27: torch.Tensor, pad: int, tc: int,
           center=None) -> torch.Tensor:
    """z-folded halo: (B, bs, bs, bs*TC) -> (B', bs+2p, bs+2p, (bs+2p)*TC)."""
    return _halo(zfeats, nbr27, pad, tc, center)


def fold_z(feats: torch.Tensor) -> torch.Tensor:
    """(B, bs, bs, bs, TC) -> (B, bs, bs, bs*TC): z folded into channels
    (z-major, t, c minor; memory order unchanged)."""
    b, bs = feats.shape[0], feats.shape[1]
    return feats.reshape(b, bs, bs, -1)


def unfold_z(zfeats: torch.Tensor, tc: int) -> torch.Tensor:
    """(B, bs, bs, bs*TC) -> (B, bs, bs, bs, TC)."""
    b, bs = zfeats.shape[0], zfeats.shape[1]
    return zfeats.reshape(b, bs, bs, bs, tc)


def pack_zband_kernel(w_dense: torch.Tensor, bs: int, pad: int) -> torch.Tensor:
    """(k, k, k, TCin, TCout) -> (k, k, (bs+2p)*TCin, bs*TCout) block-banded
    2-D kernel: output z-block zo reads halo z-blocks zo..zo+k-1 through the
    kz taps."""
    k, _, _, tcin, tcout = w_dense.shape
    h = bs + 2 * pad
    wb = w_dense.reshape(k, k, k * tcin, tcout)
    wz = w_dense.new_zeros((k, k, h * tcin, bs * tcout))
    for zo in range(bs):
        wz[:, :, zo * tcin : (zo + k) * tcin, zo * tcout : (zo + 1) * tcout] = wb
    return wz


def mask_bricks(feats: torch.Tensor, occ: torch.Tensor) -> torch.Tensor:
    """Zero phantom (voxel, t) slots: feats (B, s, s, s, T*C) with occ
    (B, s, s, s, T), or their z-folded forms."""
    return mask_slots(feats, occ)


def brick_conv_zband(zfeats, nbr27, w_dense, occz, *, mask_out: bool = True, center=None):
    """Stride-1 sparse conv in the z-folded layout: the folded halo, then one
    2-D conv whose channel axes carry z (the zband_conv kernel).

    zfeats (B, bs, bs, bs*TCin); occz (B', bs, bs, bs*T). Returns (B', bs,
    bs, bs*TCout), B' = nbr27.shape[1]. `center`: the local output block of
    zfeats under spatial sharding (see halo)."""
    k = w_dense.shape[0]
    pad = k // 2
    bs = zfeats.shape[1]
    tcin = zfeats.shape[-1] // bs
    h = halo_z(zfeats, nbr27, pad, tcin, center)
    wz = pack_zband_kernel(w_dense, bs, pad)
    out = zc.zband_conv(h, wz, k, bs)
    return mask_bricks(out, occz) if mask_out else out


def brick_conv_zband_fused(zfeats, nbr27, w_dense, scale_c, bias_c, occ_rep, res=None,
                           *, num_time: int, relu: bool = True):
    """Inference-fused zband conv: occ * [relu](conv * scale + bias [+ res]) in
    one kernel (the zband_conv_fused kernel).

    scale_c/bias_c: per-channel (C,) f32 BN affine from running stats;
    occ_rep: (B, bs, bs, bs*T*C) channel-repeated folded occupancy."""
    k = w_dense.shape[0]
    pad = k // 2
    bs = zfeats.shape[1]
    tcin = zfeats.shape[-1] // bs
    h = halo_z(zfeats, nbr27, pad, tcin)
    wz = pack_zband_kernel(w_dense, bs, pad)
    s = scale_c.float().repeat(bs * num_time)
    b = bias_c.float().repeat(bs * num_time)
    return zc.zband_conv_fused(h, wz, s, b, occ_rep, res, k=k, bs=bs, relu=relu)


def _conv3d_valid(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """VALID 3-D cross-correlation in the JAX layouts: x NDHWC, w DHWIO."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _Conv3dValid.apply(x, w)
    return _conv3d_fwd(x, w)


def _conv3d_fwd(x, w):
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2))
    return y.permute(0, 2, 3, 4, 1).contiguous()


class _Conv3dValid(torch.autograd.Function):
    """_conv3d_valid with its input gradient as a forward conv: the FULL
    correlation of dy with the kernel flipped in space and transposed in
    channels. cuDNN's own data gradient for the halo convs' shapes (many
    10^3 volumes, 16-96 channels) picks a direct kernel that took ~100 ms
    a call on an H100 at L0; as a forward conv it runs the implicit-GEMM
    kernels of the forward pass. The weight gradient is cuDNN's."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _conv3d_fwd(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        k = w.shape[0]
        dy_ = dy.permute(0, 4, 1, 2, 3)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            wt = w.permute(3, 4, 0, 1, 2).flip(2, 3, 4)  # (I, O, k, k, k)
            dx = F.conv3d(dy_, wt, padding=k - 1).permute(0, 2, 3, 4, 1)
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv3d_weight(x.permute(0, 4, 1, 2, 3), (w.shape[4], w.shape[3],
                                             k, k, k), dy_).permute(2, 3, 4, 1, 0)
        return dx, dw


def _conv3d_same(x: torch.Tensor, w: torch.Tensor, padding) -> torch.Tensor:
    """3-D cross-correlation in the JAX layouts (x NDHWC, w DHWIO) with
    symmetric zero padding per axis."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2), padding=padding)
    return y.permute(0, 2, 3, 4, 1).contiguous()


def _region_spans(d: int, bs: int):
    """Per axis for a neighbour at offset d: (source slice in the neighbour,
    kernel taps, output slice, conv padding)."""
    if d == -1:
        return slice(bs - 1, bs), slice(0, 1), slice(0, 1), 0
    if d == 0:
        return slice(0, bs), slice(0, 3), slice(0, bs), 1
    return slice(0, 1), slice(2, 3), slice(bs - 1, bs), 0


def brick_conv(feats, nbr27, w_dense, occ, mode: str = "halo", *, mask_out: bool = True,
               center=None):
    """Stride-1 sparse conv over bricks. w_dense: (k, k, k, T*Cin, T*Cout)
    in x-slowest offset order. `center`: under spatial sharding, the local
    output block of feats (feats is then the gather source; see halo).

    mode "halo": a dense VALID 3-D conv over the assembled halo. mode
    "region" (3^3 kernels): a SAME conv within each brick plus one small
    conv per neighbour region (6 faces, 12 edges, 8 corners) of the
    neighbour's boundary slab, each added into the output's boundary; no
    halo tensor. Larger kernels always run "halo", as in sps_tpu. In bf16
    the region sums are taken in f32 and cast once."""
    k = w_dense.shape[0]
    if k != 3 or mode == "halo":
        h = halo(feats, nbr27, k // 2, center)
        out = _conv3d_valid(h, w_dense).to(feats.dtype)
        return mask_bricks(out, occ) if mask_out else out
    bs = feats.shape[1]
    out = _conv3d_same(feats if center is None else center, w_dense, 1).float()
    for kk, (dx, dy, dz) in enumerate(OFFS27):
        if (dx, dy, dz) == (0, 0, 0):
            continue
        (sx, kx, ox, px), (sy, ky, oy, py), (sz, kz, oz, pz) = (
            _region_spans(d, bs) for d in (dx, dy, dz))
        slab = take_rows(feats[:, sx, sy, sz], nbr27[kk])
        out[:, ox, oy, oz] += _conv3d_same(slab, w_dense[kx, ky, kz], (px, py, pz))
    out = out.to(feats.dtype)
    return mask_bricks(out, occ) if mask_out else out


def quantize_act(feats: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-tensor symmetric int8 codes of the activations and their
    scale s_in (a 0-d f32 device tensor; no host sync). The abs-max is taken
    in the storage dtype (exact), scaling and rounding (half to even) in
    f32. Phantom slots are exact zeros and quantize to code 0."""
    amax = feats.abs().amax().float()
    s_in = torch.clamp_min(amax, 1e-12) * (1.0 / 127.0)
    inv = 1.0 / s_in
    q = torch.clamp(torch.round(feats.float() * inv), -127.0, 127.0).to(torch.int8)
    return q, s_in


def quantize_weight(w_dense: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 codes of a (k, k, k, TCin, TCout)
    kernel and their (TCout,) f32 scales s_w, from the f32 values (dividing
    by s_w, where the activations multiply by 1/s_in). The codes are stored
    as (k, k, k, TCout, TCin) and returned as its transposed view, the
    layout the CUDA kernel reads."""
    wf = w_dense.float()
    s_w = torch.clamp_min(wf.abs().amax(dim=(0, 1, 2, 3)), 1e-12) * (1.0 / 127.0)
    wt = wf.transpose(-1, -2).contiguous() / s_w[:, None]
    q = torch.clamp(torch.round(wt), -127.0, 127.0).to(torch.int8)
    return q.transpose(-1, -2), s_w


def brick_conv_int8(feats, nbr27, w_dense, occ, *, mask_out: bool = True, center=None):
    """Stride-1 sparse 3^3 conv with int8 math (inference; sps_tpu's
    brick_conv_int8): quantize the activations per tensor and the weight
    per output channel, run the int8 conv with int32 sums on the codes,
    each brick's halo gathered through nbr27 inside the kernel (the gather
    form of the brick_conv_int8 kernel), and dequantize by s_in * s_w into
    feats.dtype.

    feats (Bq, bs, bs, bs, TCin); w_dense (3, 3, 3, TCin, TCout), quantized
    from its f32 values; one output brick per column of nbr27. Under spatial
    sharding feats is the gather source and `center` the local output block:
    the scale is the abs-max of the source, as sps_tpu's (with ghosts, a
    shard's own), and the kernel reads each brick's centre through
    nbr27[13], which names the block's own row in the source (its global row
    under an all-gather, its local row under ghosts), so the codes of
    `center` are those rows' codes and are not gathered apart."""
    if center is not None and center.shape[0] != nbr27.shape[1]:
        raise ValueError(f"brick_conv_int8: center has {center.shape[0]} bricks, nbr27 "
                         f"{nbr27.shape[1]} columns")
    q, s_in = quantize_act(feats)
    w8, s_w = quantize_weight(w_dense)
    out = _int8_gather(q, nbr27, w8, s_in * s_w, feats.dtype)
    return mask_bricks(out, occ) if mask_out else out


# Input channels a launch when the int8 kernel does not take C whole (C >
# its 128, as at the brick engine's L3: 192): each chunk's int32 sums are
# below 27 * 32 * 127^2 < 2^24, so a chunk's f32 output at scale 1 is its
# sums exactly.
INT8_CHUNK = 32


def _int8_gather(q, nbr27, w8, scale, out_dtype):
    """The gather form of the int8 kernel; when it does not take C whole,
    one launch per INT8_CHUNK input channels at scale 1 in f32, the exact
    sums added in int32 and dequantized as the kernel does (f32(acc) *
    scale): bit-equal to one launch's plain version."""
    c = q.shape[-1]
    if bi8.takes_gather(q.shape, nbr27.shape, w8.shape) or c % INT8_CHUNK:
        return bi8.brick_conv_int8_gather(q, nbr27, w8, scale, out_dtype)
    ones = torch.ones_like(scale)
    acc = None
    for c0 in range(0, c, INT8_CHUNK):
        part = bi8.brick_conv_int8_gather(q[..., c0:c0 + INT8_CHUNK].contiguous(), nbr27,
                                          w8[..., c0:c0 + INT8_CHUNK, :], ones, torch.float32)
        acc = part.to(torch.int32) if acc is None else acc + part.to(torch.int32)
    return (acc.float() * scale).to(out_dtype)


def brick_conv_down(fine_feats, child, w_packed, occ_coarse, *, mask_out: bool = True):
    """Kernel-2 stride-2 conv: each child's bs^3 block reduces to the
    (bs/2)^3 output quadrant at its octant.

    w_packed: (8, T*Cin, T*Cout) in OCT_OFFSETS order."""
    bs = occ_coarse.shape[1]
    hs = bs // 2
    bf, tc = fine_feats.shape[0], fine_feats.shape[-1]
    bc = child.shape[1]
    blk = take_rows(fine_feats.reshape(bf, -1), child)  # (8, Bc, bs^3 * TC)
    blk = blk.reshape(8, bc, hs, 2, hs, 2, hs, 2, tc).permute(0, 1, 2, 4, 6, 3, 5, 7, 8)
    # (8, Bc, hs, hs, hs, 8 * TCin) in (a, b, c)-parity order, one matmul.
    blk = blk.reshape(8, bc, hs, hs, hs, 8 * tc)
    q = blk @ w_packed.reshape(8 * tc, w_packed.shape[-1])
    out = _assemble_octants(q)
    return mask_bricks(out, occ_coarse) if mask_out else out


def _expand_octants(sub: torch.Tensor, w_packed: torch.Tensor) -> torch.Tensor:
    """fine[2i+a, 2j+b, 2k+c] = sub[i, j, k] @ W[(a, b, c)]."""
    bf, hs = sub.shape[0], sub.shape[1]
    tcout = w_packed.shape[-1]
    y = torch.einsum("bxyzc,pcd->bxyzpd", sub, w_packed)
    y = y.reshape(bf, hs, hs, hs, 2, 2, 2, tcout).permute(0, 1, 4, 2, 5, 3, 6, 7)
    return y.reshape(bf, 2 * hs, 2 * hs, 2 * hs, tcout)


def brick_conv_up(coarse_feats, parent, oct_, w_packed, occ_fine, *, mask_out: bool = True):
    """Transpose kernel-2 stride-2 conv: a fine brick pulls its parent's octant
    sub-block and expands each coarse voxel into 2^3 fine voxels."""
    bf, bs = occ_fine.shape[0], occ_fine.shape[1]
    hs = bs // 2
    bc, tcin = coarse_feats.shape[0], coarse_feats.shape[-1]
    slabs = [
        coarse_feats[:, hs * a : hs * (a + 1), hs * b : hs * (b + 1), hs * c : hs * (c + 1)]
        .reshape(bc, -1)
        for a, b, c in OCT_OFFSETS
    ]
    stack = torch.cat(slabs, dim=0)  # (8*Bc, hs^3*TCin)
    oct_id = (oct_[:, 0] * 2 + oct_[:, 1]) * 2 + oct_[:, 2]
    idx = torch.where(parent >= 0, oct_id * bc + parent, -1)
    sub = take_rows(stack, idx).reshape(bf, hs, hs, hs, tcin)
    out = _expand_octants(sub, w_packed)
    return mask_bricks(out, occ_fine) if mask_out else out


def brick_conv_up_from_rows(row_feats, parent_rows, w_packed, occ_fine, *,
                            mask_out: bool = True):
    """Transpose kernel-2 stride-2 conv across the brick/row boundary: fine
    bricks pull their (bs/2)^3 parent-voxel block from coarse rows.

    row_feats (Vc, T*Cin); parent_rows (Bf, hs, hs, hs) coarse row ids."""
    bf, hs = parent_rows.shape[0], parent_rows.shape[1]
    tcin = row_feats.shape[-1]
    sub = take_rows(row_feats, parent_rows.reshape(-1)).reshape(bf, hs, hs, hs, tcin)
    out = _expand_octants(sub, w_packed)
    return mask_bricks(out, occ_fine) if mask_out else out


def pack_dense_kernel(w: torch.Tensor, num_time: int) -> torch.Tensor:
    """(K, KT, Cin, Cout) params -> (k, k, k, T*Cin, T*Cout) dense kernel."""
    k3 = w.shape[0]
    k = round(k3 ** (1 / 3))
    assert k**3 == k3
    wp = pack_time_toeplitz(w, num_time)
    return wp.reshape(k, k, k, wp.shape[-2], wp.shape[-1])
