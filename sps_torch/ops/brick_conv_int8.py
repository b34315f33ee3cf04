"""Int8 brick conv: a hand-written CUDA kernel in two forms and their plain
versions.

The conv of sps_tpu/ops/brick.py::brick_conv_int8 after quantization (an
XLA int8 conv with int32 sums there): the VALID 3x3x3 conv of the int8
halo h8 (B, 10, 10, 10, C) by the int8 weight w8 (3, 3, 3, C, N), summed in
int32, dequantized as `(float(acc) * scale).to(out_dtype)` with scale =
s_in * s_w an f32 (N,) vector. ops/brick.py quantizes around it.

The gather form, `brick_conv_int8_gather`, takes the codes q8
(Bq, 8, 8, 8, C) and the neighbour table nbr27 (27, B) and gathers each
brick's halo inside the kernel; the shipping path runs it. The halo form,
`brick_conv_int8`, takes an assembled halo tensor.

On a CUDA tensor each form launches sps_torch/csrc/brick_conv_int8.cu
through its op (torch.ops.sps_torch.brick_conv_int8_gather /
brick_conv_int8, built with the z-band kernels by ops/zband_conv.build
into build/torch_ext/), or raises: a shape outside `takes_gather` /
`takes` never falls back. On a CPU tensor it computes the plain version,
which the tests and chip_smoke.py also hold the kernel against bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from sps_torch.ops import zband_conv as zc

SOURCE = zc.CSRC / "brick_conv_int8.cu"

# One count per kernel launch, incremented only where the kernel launches:
# the halo form's and, in a dict of its own, the gather form's.
LAUNCHES = {"brick_conv_int8": 0}
GATHER_LAUNCHES = {"brick_conv_int8_gather": 0}
# The gather form's launches by shape: (B, C, N) -> count.
GATHER_SHAPE_LAUNCHES: dict[tuple, int] = {}

# The kernel's tile (brick_conv_int8.cu): threads a block, the largest C,
# columns a pass, brick side, halo side; a block's shared memory limit and
# the gather form's static shared memory (two slots of 27 staged rows).
THREADS, C_MAX, PASS_COLS, BS, H = 256, 128, 32, 8, 10
SMEM_LIMIT, ROWS_BYTES = 232448, 2 * 27 * 4
SM_SMEM = 233472  # an SM's shared memory, 1 KB of it reserved per block


def reset_launches() -> None:
    LAUNCHES["brick_conv_int8"] = 0
    GATHER_LAUNCHES["brick_conv_int8_gather"] = 0
    GATHER_SHAPE_LAUNCHES.clear()


def takes(h_shape, w_shape) -> bool:
    """Whether the kernel takes a call, from its shapes alone: h8
    (B, 10, 10, 10, C) and w8 (3, 3, 3, C, N) with C % 16 == 0,
    16 <= C <= 128, and N == 16 or N a multiple of 32. Every int8 call of
    the shipping path (brick side 8; C 16, 32, 48, 64, 96; N 16, 32, 64)
    qualifies."""
    if len(h_shape) != 5 or tuple(h_shape[1:4]) != (H, H, H):
        return False
    if len(w_shape) != 5 or tuple(w_shape[:3]) != (3, 3, 3) or w_shape[3] != h_shape[4]:
        return False
    c, n = h_shape[4], w_shape[4]
    return c % 16 == 0 and 16 <= c <= C_MAX and (n == 16 or (n > 0 and n % PASS_COLS == 0))


def takes_gather(q_shape, nbr_shape, w_shape) -> bool:
    """Whether the gather form takes a call, from its shapes alone: q8
    (Bq, 8, 8, 8, C), nbr27 (27, B) and w8 under `takes`'s rule for a halo
    of B bricks."""
    if len(q_shape) != 5 or tuple(q_shape[1:4]) != (BS, BS, BS):
        return False
    if len(nbr_shape) != 2 or nbr_shape[0] != 27:
        return False
    return takes((nbr_shape[1], H, H, H, q_shape[4]), w_shape)


def row_stride(c: int) -> int:
    """Bytes between neighbouring halo voxels (and weight columns) in shared
    memory: an odd number of 16-byte units, so that the 8 rows of one
    ldmatrix fall in 8 different bank groups."""
    return c if (c // 16) % 2 == 1 else c + 16


def smem_plan(c: int, n: int) -> dict[str, int]:
    """The kernel's shared memory in bytes: the brick's halo (1000 voxels at
    row_stride(c)) and two weight slots of one tap's pass columns."""
    s = row_stride(c)
    cols = 16 if n == 16 else PASS_COLS
    halo = H**3 * s
    slot = cols * s
    return dict(stride=s, halo_bytes=halo, slot_bytes=slot, pass_cols=cols,
                passes=n // cols, smem_bytes=halo + 2 * slot)


def blocks_fit(smem: int) -> int:
    """Blocks of `smem` dynamic shared bytes that one SM holds."""
    return SM_SMEM // (smem + ROWS_BYTES + 1024)


def gather_plan(c: int, n: int) -> dict[str, int]:
    """The gather form's shared memory in bytes (brick_conv_int8.cu's
    gather_plan): `bufs` halo buffers, then the 27 taps of one pass's
    columns. A pass is 32 columns (16 when n = 16, or when 32 do not fit
    beside one buffer). Two buffers (the next brick's copy overlaps the
    brick's math in the block) where two such blocks fit on an SM or one
    buffer would fit no more blocks; else one buffer (the next brick's
    copy waits for the brick's math; the SM's other blocks compute)."""
    s = row_stride(c)
    halo = H**3 * s
    cols = 16 if n == 16 or halo + 27 * PASS_COLS * s + ROWS_BYTES > SMEM_LIMIT else PASS_COLS
    weight = 27 * cols * s
    one, two = halo + weight, 2 * halo + weight
    bufs = 2 if (two + ROWS_BYTES <= SMEM_LIMIT
                 and (blocks_fit(two) >= 2 or blocks_fit(two) >= blocks_fit(one))) else 1
    return dict(stride=s, halo_bytes=halo, pass_cols=cols, passes=n // cols,
                weight_bytes=weight, bufs=bufs, smem_bytes=bufs * halo + weight)


def block_bricks(block: int, grid: int, b: int) -> range:
    """The bricks (columns of nbr27) that block `block` of a grid of `grid`
    persistent blocks walks in the gather form, in order."""
    return range(block, b, grid)


def gather_events(block: int, grid: int, centre, bufs: int, passes: int = 1) -> list[tuple]:
    """The gather form's steps for one block, in the kernel's order, for
    the centre rows `centre` (nbr27[13]): ("weight", pass) the pass's
    weight copy; ("barrier",); ("wait",) the thread's copies landed;
    ("gather", brick, buffer) a brick's halo copy issued; ("math", brick,
    buffer, pass) its taps multiplied (its outputs are stored after the
    steps listed with it); ("zero", brick) an empty slot's +0.0 stored. A
    block past the last brick does nothing."""
    b = len(centre)
    bricks = block_bricks(block, grid, b)
    ev: list[tuple] = []
    if not bricks:
        return ev
    for p in range(passes):
        if p:
            ev.append(("barrier",))
        ev.append(("weight", p))
        ev.append(("barrier",))  # the first brick's rows staged
        if centre[bricks[0]] >= 0:
            ev.append(("gather", bricks[0], 0))
        for it, brick in enumerate(bricks):
            cur, nxt = (it % 2, (it + 1) % 2) if bufs == 2 else (0, 0)
            bn = brick + grid
            busy = centre[brick] >= 0
            following = bn < b and centre[bn] >= 0
            ev += [("wait",), ("barrier",)]
            if following and (bufs == 2 or not busy):
                ev.append(("gather", bn, nxt))
            if busy:
                ev.append(("math", brick, cur, p))
                if bufs == 1:
                    ev.append(("barrier",))
                    if following:
                        ev.append(("gather", bn, nxt))
            elif p == 0:
                ev.append(("zero", brick))
    return ev


def halo_piece(i: int, c: int) -> tuple[int, int]:
    """(byte offset into the brick's h8, byte offset into shared memory) of
    the halo's 16-byte copy i: group i % (C/16) of voxel i / (C/16)."""
    v, q = divmod(i, c // 16)
    return 16 * i, v * row_stride(c) + 16 * q


def _axis(h: int) -> tuple[int, int]:
    """Halo coordinate h on one axis -> (neighbour index 0, 1, 2 for
    offset -1, 0, +1; local coordinate in that brick): h = 0 is local 7 of
    neighbour -1, h = 1..8 local h - 1 of the centre, h = 9 local 0 of
    neighbour +1."""
    return divmod(h + BS - 1, BS)


def gather_piece(i: int, rows27, c: int, buf: int = 0) -> tuple[int | None, int]:
    """(byte offset into q8, or None where nothing is read; byte offset into
    shared memory) of the gather form's 16-byte copy i into halo buffer
    `buf` for a brick whose 27 neighbour rows (OFFS27 order) are rows27:
    group i % (C/16) of halo voxel v = i / (C/16) = (hx * 10 + hy) * 10 +
    hz. None where that neighbour's row is -1 (the copy zero-fills) and for
    every piece of a brick whose centre row is -1 (its block stores zeros
    and copies nothing)."""
    v, q = divmod(i, c // 16)
    dst = (buf * H**3 + v) * row_stride(c) + 16 * q
    (nx, lx), (ny, ly), (nz, lz) = (_axis(h) for h in (v // (H * H), v // H % H, v % H))
    r = int(rows27[(nx * 3 + ny) * 3 + nz])
    if r < 0 or int(rows27[13]) < 0:
        return None, dst
    return (((r * BS + lx) * BS + ly) * BS + lz) * c + 16 * q, dst


def weight_piece(i: int, tap: int, n0: int, c: int, n: int) -> tuple[int, int]:
    """(byte offset into wt (27, N, C), byte offset into the slot) of copy i
    of a tap's pass starting at column n0: group i % (C/16) of column
    n0 + i / (C/16)."""
    r, q = divmod(i, c // 16)
    return (tap * n + n0 + r) * c + 16 * q, r * row_stride(c) + 16 * q


def resident_weight_piece(i: int, n0: int, c: int, n: int) -> tuple[int, int]:
    """(byte offset into wt (27, N, C), byte offset from the gather form's
    weight region) of copy i of the pass starting at column n0, all 27
    taps: group i % (C/16) of row r = i / (C/16) = tap * cols + column, at
    r * row_stride(c); tap t's slot starts at t * cols * row_stride(c)."""
    cols = gather_plan(c, n)["pass_cols"]
    r, q = divmod(i, c // 16)
    tap, col = divmod(r, cols)
    return (tap * n + n0 + col) * c + 16 * q, r * row_stride(c) + 16 * q


def a_row(warp: int, lane: int, i: int, tap: int, c: int) -> int:
    """Shared-memory byte address (from the halo's base, before the step's
    c0) of the row lane `lane` gives ldmatrix for m16 tile i of warp `warp`
    at tap `tap`: output voxel (warp, 2i + r/8, r%8), r = lane % 16, reads
    halo voxel (warp+kx, 2i+r/8+ky, r%8+kz); lanes 16..31 the upper 16 bytes
    of a k32 step."""
    kx, ky, kz = tap // 9, tap // 3 % 3, tap % 3
    r = lane & 15
    v = ((warp + kx) * H + 2 * i + (r >> 3) + ky) * H + (r & 7) + kz
    return v * row_stride(c) + (lane >> 4) * 16


def b_row(lane: int, j: int, k32: bool, c: int) -> int:
    """Byte address in a weight slot (before c0) of the row lane `lane`
    gives ldmatrix for n8 tiles j, j+1: x4 at a k32 step (matrices: tile j
    bytes 0-15, 16-31, tile j+1 bytes 0-15, 16-31), x2 at a k16 step."""
    s = row_stride(c)
    if k32:
        m = lane >> 3
        return ((j + (m >> 1)) * 8 + (lane & 7)) * s + (m & 1) * 16
    return ((j + ((lane >> 3) & 1)) * 8 + (lane & 7)) * s


def brick_conv_int8_ref(h8: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor,
                        out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version: the int32 sums from an f64 conv of the codes (exact:
    |acc| <= 27 * 128 * 127**2 < 2**53), then the same dequant."""
    acc = F.conv3d(h8.double().permute(0, 4, 1, 2, 3), w8.double().permute(4, 3, 0, 1, 2))
    acc = acc.permute(0, 2, 3, 4, 1).round().to(torch.int32)
    return (acc.float() * scale).to(out_dtype)


_GATHER_MAPS: dict = {}


def _gather_map(bs: int, device):
    """For a brick side bs: the OFFS27 index of the neighbour that holds
    each voxel of the (bs+2)^3 halo and the voxel within that neighbour,
    two ((bs+2)^3,) tables uploaded once per device."""
    key = (bs, str(device))
    if key not in _GATHER_MAPS:
        h = bs + 2
        n, loc = divmod(np.arange(h) + bs - 1, bs)
        x, y, z = np.meshgrid(np.arange(h), np.arange(h), np.arange(h), indexing="ij")
        k = (n[x] * 3 + n[y]) * 3 + n[z]
        vox = (loc[x] * bs + loc[y]) * bs + loc[z]
        _GATHER_MAPS[key] = tuple(torch.as_tensor(a.reshape(-1), dtype=torch.long, device=device)
                                  for a in (k, vox))
    return _GATHER_MAPS[key]


def halo_gather_ref(q8: torch.Tensor, nbr27: torch.Tensor) -> torch.Tensor:
    """Plain halo of the codes: (Bq, bs, bs, bs, C) through (27, B) rows ->
    (B, bs+2, bs+2, bs+2, C), zeros where a row is -1 (ops/brick.halo's
    function at pad 1, written here because ops/brick.py imports this
    module)."""
    bq, bs, c = q8.shape[0], q8.shape[1], q8.shape[-1]
    k, vox = _gather_map(bs, q8.device)
    rows = nbr27.long()[k]  # ((bs+2)^3, B)
    flat = torch.where(rows >= 0, rows * bs**3 + vox[:, None], bq * bs**3)
    src = torch.cat([q8.reshape(-1, c), q8.new_zeros((1, c))])
    return src[flat.t()].reshape((-1,) + (bs + 2,) * 3 + (c,))


def brick_conv_int8_gather_ref(q8: torch.Tensor, nbr27: torch.Tensor, w8: torch.Tensor,
                               scale: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of the gather form: the halo conv of halo_gather_ref,
    and +0.0 for a brick whose centre row is -1, as the kernel gives."""
    out = brick_conv_int8_ref(halo_gather_ref(q8, nbr27), w8, scale, out_dtype)
    return out.masked_fill((nbr27[13] < 0).view(-1, 1, 1, 1, 1), 0.0)


def brick_conv_int8_gather(q8: torch.Tensor, nbr27: torch.Tensor, w8: torch.Tensor,
                           scale: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """q8 (Bq, 8, 8, 8, C) int8 codes, nbr27 (27, B) int32 neighbour rows
    (OFFS27 order, -1 where absent), w8 (3, 3, 3, C, N) int8, scale (N,) f32
    -> (B, 8, 8, 8, N) in out_dtype (bf16 or f32) (the plain version also
    takes other brick sides and integer dtypes): brick b's output is the
    halo form's on the halo that nbr27[:, b] gathers from q8, and zeros
    where nbr27[13, b] is -1.

    The rows must lie in [-1, Bq), as the atlas's tables do: the kernel
    reads a row's codes unchecked, and checking the values would wait for
    the device, so only the shapes are checked. q8 and nbr27 must be
    contiguous and nbr27 int32: the wrapper never copies or casts them. The
    weight is read transposed, as by `brick_conv_int8`."""
    if q8.device.type == "cpu":
        return brick_conv_int8_gather_ref(q8, nbr27, w8, scale, out_dtype)
    if q8.device.type != "cuda":
        raise ValueError(f"brick_conv_int8_gather: the kernel takes CUDA tensors, got {q8.device}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"brick_conv_int8_gather: output dtype {out_dtype} (bf16 or f32 only)")
    if q8.dtype != torch.int8 or nbr27.dtype != torch.int32:
        raise ValueError(f"brick_conv_int8_gather: q8 {q8.dtype}, nbr27 {nbr27.dtype} "
                         "(int8 and int32 only)")
    if not (q8.is_contiguous() and nbr27.is_contiguous()):
        raise ValueError("brick_conv_int8_gather: q8 and nbr27 must be contiguous")
    if not takes_gather(q8.shape, nbr27.shape, w8.shape):
        raise ValueError(f"brick_conv_int8_gather: the kernel does not take q8 "
                         f"{tuple(q8.shape)}, nbr27 {tuple(nbr27.shape)}, w8 {tuple(w8.shape)}")
    zc.build()
    wt = w8.transpose(-1, -2).contiguous()
    with torch.cuda.device(q8.device):
        stream = torch.cuda.current_stream().cuda_stream
        out = torch.ops.sps_torch.brick_conv_int8_gather(q8, nbr27, wt, scale,
                                                         out_dtype == torch.bfloat16, stream)
    GATHER_LAUNCHES["brick_conv_int8_gather"] += 1
    key = (nbr27.shape[1], q8.shape[-1], w8.shape[-1])
    GATHER_SHAPE_LAUNCHES[key] = GATHER_SHAPE_LAUNCHES.get(key, 0) + 1
    return out


def brick_conv_int8(h8: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor,
                    out_dtype: torch.dtype) -> torch.Tensor:
    """h8 (B, 10, 10, 10, C) int8, w8 (3, 3, 3, C, N) int8, scale (N,) f32 ->
    (B, 8, 8, 8, N) in out_dtype (bf16 or f32).

    The kernel reads the weight transposed, (3, 3, 3, N, C) contiguous: a w8
    that is the transposed view of such a tensor (ops/brick.quantize_weight
    makes it so) costs no copy."""
    if h8.device.type == "cpu":
        return brick_conv_int8_ref(h8, w8, scale, out_dtype)
    if h8.device.type != "cuda":
        raise ValueError(f"brick_conv_int8: the kernel takes CUDA tensors, got {h8.device}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"brick_conv_int8: output dtype {out_dtype} (bf16 or f32 only)")
    if not takes(h8.shape, w8.shape):
        raise ValueError(f"brick_conv_int8: the kernel does not take h8 {tuple(h8.shape)}, "
                         f"w8 {tuple(w8.shape)}")
    zc.build()
    wt = w8.transpose(-1, -2).contiguous()
    with torch.cuda.device(h8.device):
        stream = torch.cuda.current_stream().cuda_stream
        out = torch.ops.sps_torch.brick_conv_int8(h8, wt, scale, out_dtype == torch.bfloat16,
                                                  stream)
    LAUNCHES["brick_conv_int8"] += 1
    return out
