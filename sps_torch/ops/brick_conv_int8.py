"""Int8 brick conv: a hand-written CUDA kernel and its plain version.

The conv of sps_tpu/ops/brick.py::brick_conv_int8 after quantization (an
XLA int8 conv with int32 sums there): the VALID 3x3x3 conv of the int8
halo h8 (B, 10, 10, 10, C) by the int8 weight w8 (3, 3, 3, C, N), summed in
int32, dequantized as `(float(acc) * scale).to(out_dtype)` with scale =
s_in * s_w an f32 (N,) vector. ops/brick.py quantizes and assembles the
halo around it.

On a CUDA tensor `brick_conv_int8` launches sps_torch/csrc/brick_conv_int8.cu
through torch.ops.sps_torch.brick_conv_int8 (built with the z-band kernels
by ops/zband_conv.build into build/torch_ext/), or raises: a shape outside
`takes` never falls back. On a CPU tensor it computes the plain version,
which the tests and chip_smoke.py also hold the kernel against bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sps_torch.ops import zband_conv as zc

SOURCE = zc.CSRC / "brick_conv_int8.cu"

# One count per kernel launch, incremented only where the kernel launches.
LAUNCHES = {"brick_conv_int8": 0}

# The kernel's tile (brick_conv_int8.cu): threads a block (one brick), the
# largest C, columns a pass, halo side.
THREADS, C_MAX, PASS_COLS, H = 256, 128, 32, 10


def reset_launches() -> None:
    LAUNCHES["brick_conv_int8"] = 0


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


def halo_piece(i: int, c: int) -> tuple[int, int]:
    """(byte offset into the brick's h8, byte offset into shared memory) of
    the halo's 16-byte copy i: group i % (C/16) of voxel i / (C/16)."""
    v, q = divmod(i, c // 16)
    return 16 * i, v * row_stride(c) + 16 * q


def weight_piece(i: int, tap: int, n0: int, c: int, n: int) -> tuple[int, int]:
    """(byte offset into wt (27, N, C), byte offset into the slot) of copy i
    of a tap's pass starting at column n0: group i % (C/16) of column
    n0 + i / (C/16)."""
    r, q = divmod(i, c // 16)
    return (tap * n + n0 + r) * c + 16 * q, r * row_stride(c) + 16 * q


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
