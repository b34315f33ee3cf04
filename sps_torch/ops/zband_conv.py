"""Z-band brick convolution: hand-written CUDA kernels and their plain versions.

Counterpart of sps_tpu/ops/pallas_conv.py. The z-band formulation
(ops/brick.py: fold_z / pack_zband_kernel / brick_conv_zband) turns a
stride-1 sparse 3-D conv over bricks into one VALID 2-D conv whose channel
axes carry the folded z dimension:

    out[b, xo, yo, n] = sum_{kx, ky < k} sum_c hz[b, xo+kx, yo+ky, c] * wz[kx, ky, c, n]

`zband_conv` returns it in hz's dtype; `zband_conv_fused` applies the
inference epilogue `occ * [relu](acc * scale + bias [+ res])` in f32
before the one cast.

`zband_conv` is a torch.autograd.Function: its forward is the kernel (or
the plain version on the CPU), its backward `zband_conv_bwd` is plain
PyTorch, as sps_tpu's is XLA (pallas_conv.py:406-442): d_hz by k*k
shifted matmuls with dout, d_wz by k*k contractions over (b, xo, yo), both
summed in f32 and cast to the inputs' dtypes. `zband_conv_fused` is
inference-only and raises when a gradient is asked of an operand.

On a CUDA tensor both launch a hand-written kernel through the ops that
sps_torch/csrc/zband_conv_op.cpp registers (torch.ops.sps_torch.*). The
call's shape picks the kernel (`route`): "wgmma" runs
sps_torch/csrc/zband_conv_sm90.cu (bf16, k = 3, bs = 8, C % 32 == 0,
N % 128 == 0, 16-byte aligned: both block8 convs of L0 and the k = 3
microbenchmark), "wgmma_k5" runs sps_torch/csrc/zband_conv_k5_sm90.cu
(the unfused conv in bf16 at k = 5, bs = 8, C % 8 == 0 with C <= 24,
N % 128 == 0, 16-byte aligned: the stem), "wgmma_k5_wide" runs
sps_torch/csrc/zband_conv_k5_wide_sm90.cu (the same at C = 48: the stem
of DIST_FEATURE), "wgmma_f32" runs
sps_torch/csrc/zband_conv_tf32x3_sm90.cu (f32 at k = 3 as "wgmma" and at
the unfused k = 5 stem with C % 8 == 0, C <= 48, on 3xTF32 wgmma), "wmma"
runs sps_torch/csrc/zband_conv.cu (every other shape: small and ragged
shapes in f32 and bf16). No flag picks a route, and a route that does not
take a shape raises. The library is built at first
use into build/torch_ext/ (one nvcc per CUDA source for sm_90a and the
host compiler, all started together, then one link) and rebuilt when a
source changes. A build or launch failure raises. On a CPU tensor they
compute the plain version (`*_ref`), which the tests and chip_smoke.py
also hold the kernels against.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
CUDA_SOURCES = (CSRC / "zband_conv.cu", CSRC / "zband_conv_sm90.cu",
                CSRC / "zband_conv_k5_sm90.cu", CSRC / "zband_conv_tf32x3_sm90.cu",
                CSRC / "zband_conv_k5_wide_sm90.cu", CSRC / "brick_conv_int8.cu")
OP_SOURCE = CSRC / "zband_conv_op.cpp"
SOURCES = (*CUDA_SOURCES, OP_SOURCE)
HEADERS = (CSRC / "sm90_wgmma.cuh",)  # included by the four wgmma sources
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_ext"

# Route name -> the op's route argument: 0 runs zband_conv.cu (WMMA), 1
# zband_conv_sm90.cu (wgmma, k = 3), 2 zband_conv_k5_sm90.cu (wgmma, the
# k = 5 stem), 3 zband_conv_tf32x3_sm90.cu (f32 on 3xTF32 wgmma, both), 4
# zband_conv_k5_wide_sm90.cu (wgmma, the k = 5 stem at C = 48).
ROUTES = {"wmma": 0, "wgmma": 1, "wgmma_k5": 2, "wgmma_f32": 3, "wgmma_k5_wide": 4}
ROUTE_SOURCES = {"wmma": CUDA_SOURCES[0], "wgmma": CUDA_SOURCES[1],
                 "wgmma_k5": CUDA_SOURCES[2], "wgmma_f32": CUDA_SOURCES[3],
                 "wgmma_k5_wide": CUDA_SOURCES[4]}

# One count per kernel launch; incremented only where the kernel launches,
# in total, per route, and per (kernel, route, hz shape, wz shape).
LAUNCHES = {"zband_conv": 0, "zband_conv_fused": 0}
ROUTE_LAUNCHES = {name: dict.fromkeys(ROUTES, 0) for name in LAUNCHES}
SHAPE_LAUNCHES: dict[tuple, int] = {}

# The wgmma route's tile (zband_conv_sm90.cu): channels per stage, columns
# per block, bricks per block, threads, stages, the channel multiple it
# takes, and the block's shared memory limit on Hopper.
SM90_CK, SM90_BN, SM90_BRICKS, SM90_THREADS, SM90_STAGES = 16, 128, 4, 256, 4
SM90_C_MULTIPLE = 32
SMEM_LIMIT = 232448

# The wgmma_k5 route's tile (zband_conv_k5_sm90.cu): taps per side, brick
# side, 8-channel groups staged per tap (C <= 8 * K5_GROUPS), group slots
# of a halo (two k16 steps), columns per block, bricks per block, threads.
K5_KS, K5_BS, K5_GROUPS, K5_A_GROUPS, K5_BN, K5_BRICKS, K5_THREADS = 5, 8, 3, 4, 128, 6, 384

# The channels of the DIST_FEATURE stem, the one C that the wgmma_k5_wide
# route (zband_conv_k5_wide_sm90.cu) takes and the widest k = 5 call of
# the wgmma_f32 route.
K5W_C = 48

# The wgmma_f32 route's tile (zband_conv_tf32x3_sm90.cu): channels per
# chunk (one k8 step), columns per block, bricks per block, threads, and
# the bytes of one tap's weight chunk (hi or lo).
F32_CK, F32_BN, F32_BRICKS, F32_THREADS = 8, 128, 4, 256
F32_W_TAP = F32_CK // 4 * (F32_BN // 8) * 128

_loaded = False
build_log = ""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the z-band kernels are built at first use")
    return found


def _run(cmds: list[list[str]]) -> str:
    """Run the commands concurrently; raise with their output if one fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for p, c, out in zip(procs, cmds, outs):
        if p.returncode != 0:
            raise RuntimeError(f"{c[0]} failed ({p.returncode}):\n{out}")
    return "".join(outs)


def build() -> None:
    """Compile (if a source changed) and load the port's kernel library,
    which registers torch.ops.sps_torch.zband_conv, zband_conv_fused and
    brick_conv_int8 (sps_torch/ops/brick_conv_int8.py builds through here)."""
    global _loaded, build_log
    if _loaded:
        return
    from torch.utils import cpp_extension

    h = hashlib.sha256(torch.__version__.encode())
    for src in (*SOURCES, *HEADERS):
        h.update(src.read_bytes())
    digest = h.hexdigest()[:16]
    so = BUILD_DIR / f"zband_conv_{digest}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        stem = BUILD_DIR / f"zband_conv_{digest}.{os.getpid()}"
        objs = [Path(f"{stem}.{src.name}.o") for src in SOURCES]
        tmp = Path(f"{stem}.tmp.so")
        nvcc = _nvcc()
        abi = int(torch._C._GLIBCXX_USE_CXX11_ABI)
        build_log = _run([
            *([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-c", str(src), "-o", str(obj)]
              for src, obj in zip(CUDA_SOURCES, objs)),
            [os.environ.get("CXX", "g++"), "-std=c++17", "-O2", "-fPIC", "-w",
             f"-D_GLIBCXX_USE_CXX11_ABI={abi}",
             *(f"-I{p}" for p in cpp_extension.include_paths()),
             "-c", str(OP_SOURCE), "-o", str(objs[-1])],
        ])
        libdir = cpp_extension.library_paths()[0]
        build_log += _run([[nvcc, "-shared", *map(str, objs), "-o", str(tmp),
                            f"-L{libdir}", "-lc10", "-ltorch", "-ltorch_cpu",
                            "-Xlinker", f"-rpath,{libdir}"]])
        os.replace(tmp, so)
        for obj in objs:
            obj.unlink()
    torch.ops.load_library(str(so))
    _loaded = True


def reset_launches() -> None:
    """Set every launch count, in total, per route and per shape, to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        ROUTE_LAUNCHES[name] = dict.fromkeys(ROUTES, 0)
    SHAPE_LAUNCHES.clear()


def route(hz: torch.Tensor, wz: torch.Tensor, k: int, bs: int, *operands) -> str:
    """The kernel a CUDA call runs, from its shape and dtype alone. With
    bs * bs = 64, N % 128 == 0 and every operand (hz, wz and the fused
    call's scale, bias, occ, res) 16-byte aligned: at k = 3 with
    C % 32 == 0, "wgmma" (zband_conv_sm90.cu) in bf16 and "wgmma_f32"
    (zband_conv_tf32x3_sm90.cu) in f32; for the unfused call (no operands)
    at k = 5 with C % 8 == 0, in bf16 "wgmma_k5" (zband_conv_k5_sm90.cu) at
    0 < C <= 24 and "wgmma_k5_wide" (zband_conv_k5_wide_sm90.cu) at C = 48,
    in f32 "wgmma_f32" at 0 < C <= 48. Else "wmma" (zband_conv.cu)."""
    c = hz.shape[-1]
    bf16 = hz.dtype == torch.bfloat16
    ok = ((bf16 or hz.dtype == torch.float32) and bs * bs == 64 and wz.shape[-1] % SM90_BN == 0
          and all(t.data_ptr() % 16 == 0 for t in (hz, wz, *operands) if t is not None))
    if ok and k == 3 and c % SM90_C_MULTIPLE == 0:
        return "wgmma" if bf16 else "wgmma_f32"
    if ok and k == K5_KS and not operands and c % 8 == 0 and 0 < c:
        if bf16 and c <= 8 * K5_GROUPS:
            return "wgmma_k5"
        if bf16 and c == K5W_C:
            return "wgmma_k5_wide"
        if not bf16 and c <= K5W_C:
            return "wgmma_f32"
    return "wmma"


def sm90_smem_plan(h: int = 10, taps: int = 9) -> dict[str, int]:
    """One stage of the wgmma route's shared memory, in bytes, with the
    formulas of zband_conv_sm90.cu: a brick's halo chunk as K-major core
    matrices [8-channel group][pixel][8 channels] (a_sbo: next 8 output
    rows, i.e. the next xo; a_lbo: next 8 channels), then the taps' weight
    chunks as MN-major core matrices [8-channel group][8-column group][8][8]
    (b_sbo: next 8 columns; b_lbo: next 8 channels)."""
    a_lbo, b_sbo = h * h * 16, 8 * 16
    halo = SM90_CK // 8 * a_lbo
    w_tap = SM90_CK * SM90_BN * 2
    w_offset = SM90_BRICKS * halo
    return dict(a_sbo=h * 16, a_lbo=a_lbo, halo_bytes=halo, b_sbo=b_sbo,
                b_lbo=SM90_BN // 8 * b_sbo, w_tap_bytes=w_tap, w_offset=w_offset,
                stage_bytes=w_offset + taps * w_tap)


def sm90_descriptors(brick: int, kx: int, ky: int, ks: int, h: int = 10, k: int = 3):
    """(start, lbo, sbo) in bytes from the stage's base of the A and B
    operands of one wgmma: the block's brick `brick`, tap (kx, ky), k-step
    ks (channels 16*ks .. +16 of the chunk)."""
    p = sm90_smem_plan(h, k * k)
    a = (brick * p["halo_bytes"] + ks * 2 * p["a_lbo"] + (kx * h + ky) * 16,
         p["a_lbo"], p["a_sbo"])
    b = (p["w_offset"] + (kx * k + ky) * p["w_tap_bytes"] + ks * 2 * p["b_lbo"],
         p["b_lbo"], p["b_sbo"])
    return a, b


def sm90_halo_piece(i: int, c: int, c0: int, h: int = 10):
    """(brick, element offset into hz from the block's first brick, byte
    offset from the stage's base) of the halo's 16-byte copy i
    (zband_conv_sm90.cu::load_chunk): channel group i % (CK/8) of pixel
    i / (CK/8)."""
    groups = SM90_CK // 8
    g, rest = i % groups, i // groups
    brick, pix = divmod(rest, h * h)
    p = sm90_smem_plan(h)
    return (brick, (brick * h * h + pix) * c + c0 + g * 8,
            brick * p["halo_bytes"] + g * p["a_lbo"] + pix * 16)


def sm90_weight_piece(tid: int, it: int, c: int, n: int, c0: int, n0: int):
    """(element offset into wz, byte offset from the stage's base) of the
    weight's 16-byte copy of thread tid on step it of load_chunk (tap
    it / sweeps, sweep it % sweeps)."""
    sweeps = SM90_CK * SM90_BN // 8 // SM90_THREADS
    r, j, kg = tid & 7, (tid >> 3) & 15, tid >> 7
    tap, sweep = divmod(it, sweeps)
    p = sm90_smem_plan()
    return ((tap * c + c0 + (kg + 2 * sweep) * 8 + r) * n + n0 + j * 8,
            p["w_offset"] + tid * 16 + tap * p["w_tap_bytes"] + sweep * SM90_THREADS * 16)


def k5_smem_plan() -> dict[str, int]:
    """The wgmma_k5 route's shared memory, in bytes, with the formulas of
    zband_conv_k5_sm90.cu: each brick's whole halo as K-major core matrices
    [group slot][pixel][8 channels] (a_sbo: next 8 output rows, i.e. the
    next xo; a_lbo: next 8 channels; 4 slots, those at and past C/8
    zeroed), then all 25 taps' weights as MN-major core matrices
    [8-channel group][8-column group][8][8] (b_sbo: next 8 columns; b_lbo:
    next 8 channels; 3 groups a tap), then the zeroed group of weight rows
    that faces slot 3."""
    h = K5_BS + K5_KS - 1
    a_lbo, b_sbo = h * h * 16, 8 * 16
    b_lbo = K5_BN // 8 * b_sbo
    halo = K5_A_GROUPS * a_lbo
    w_tap = K5_GROUPS * b_lbo
    w_offset = K5_BRICKS * halo
    pad = w_offset + K5_KS * K5_KS * w_tap
    return dict(a_sbo=h * 16, a_lbo=a_lbo, halo_bytes=halo, b_sbo=b_sbo, b_lbo=b_lbo,
                w_tap_bytes=w_tap, w_offset=w_offset, pad_offset=pad, smem_bytes=pad + b_lbo)


def k5_descriptors(brick: int, kx: int, ky: int, ks: int):
    """(start, lbo, sbo) in bytes from the buffer's base of the A and B
    operands of one wgmma of the wgmma_k5 route: the block's brick
    `brick`, tap (kx, ky), k-step ks (group slots 2*ks and 2*ks + 1). The
    B operand of k-step 1 reaches its second group, the rows facing the
    halo's zero slot 3, through its lbo: the zeroed pad."""
    p = k5_smem_plan()
    h = K5_BS + K5_KS - 1
    a = (brick * p["halo_bytes"] + ks * 2 * p["a_lbo"] + (kx * h + ky) * 16,
         p["a_lbo"], p["a_sbo"])
    w_tap = p["w_offset"] + (kx * K5_KS + ky) * p["w_tap_bytes"]
    lbo = p["b_lbo"] if ks == 0 else p["pad_offset"] - (w_tap + 2 * p["b_lbo"])
    return a, (w_tap + ks * 2 * p["b_lbo"], lbo, p["b_sbo"])


def k5_halo_piece(i: int, c: int):
    """(brick, element offset into hz from the block's first brick, byte
    offset from the buffer's base) of the halo's 16-byte copy i
    (zband_conv_k5_sm90.cu::load_halos): channel group i % (C/8) of pixel
    i / (C/8) of the brick."""
    cg, h = c // 8, K5_BS + K5_KS - 1
    brick, rest = divmod(i, h * h * cg)
    pix, g = divmod(rest, cg)
    p = k5_smem_plan()
    return brick, brick * h * h * c + rest * 8, brick * p["halo_bytes"] + g * p["a_lbo"] + pix * 16


def k5_weight_piece(e: int, kx: int, c: int, n: int, n0: int):
    """(element offset into wz, byte offset from the buffer's base) of the
    16-byte copy e of row kx of taps (zband_conv_k5_sm90.cu::load_weight_row)."""
    ky, rest = divmod(e, c // 8 * K5_BN)
    kg, j, r = rest >> 7, (rest >> 3) & 15, rest & 7
    tap = kx * K5_KS + ky
    p = k5_smem_plan()
    return ((tap * c + kg * 8 + r) * n + n0 + j * 8,
            p["w_offset"] + tap * p["w_tap_bytes"] + rest * 16)


def k5_zero_ranges(c: int) -> list[tuple[int, int]]:
    """The byte ranges zband_conv_k5_sm90.cu::zero_slots zeroes: each
    halo's slots from C/8 on, each tap's weight groups from C/8 on (none
    at C = 24) and the pad."""
    cg, p = c // 8, k5_smem_plan()
    halos = [(b * p["halo_bytes"] + cg * p["a_lbo"], (b + 1) * p["halo_bytes"])
             for b in range(K5_BRICKS)]
    taps = [(p["w_offset"] + t * p["w_tap_bytes"] + cg * p["b_lbo"],
             p["w_offset"] + (t + 1) * p["w_tap_bytes"])
            for t in range(K5_KS * K5_KS) if cg < K5_GROUPS]
    return [*halos, *taps, (p["pad_offset"], p["smem_bytes"])]


def f32_smem_plan(k: int) -> dict[str, int]:
    """The wgmma_f32 route's shared memory at k taps a side, in bytes, with
    the formulas of zband_conv_tf32x3_sm90.cu (Geo<k>): two halo sets (chunk
    q % 2), each the block's bricks' hi halos then their lo halos, a brick's
    chunk as K-major core matrices [4-channel group][pixel][4 channels]
    (a_sbo: next 8 output rows, i.e. the next xo; a_lbo: next 4 channels);
    then two weight sets (step % 2), each the step's taps hi then lo, a tap
    as K-major core matrices [4-channel group][8-column group][8][4] (b_sbo:
    next 8 columns; b_lbo: next 4 channels). A step is all 9 taps at k = 3,
    one row of 5 at k = 5."""
    h = 8 + k - 1
    a_lbo = h * h * 16
    halo = F32_CK // 4 * a_lbo
    halo_set = 2 * F32_BRICKS * halo
    step_taps = k * k if k == 3 else k
    w_set = 2 * step_taps * F32_W_TAP
    return dict(h=h, a_sbo=h * 16, a_lbo=a_lbo, halo_bytes=halo, halo_set=halo_set,
                b_sbo=128, b_lbo=F32_BN // 8 * 128, step_taps=step_taps,
                steps=k * k // step_taps, w_set=w_set, w_offset=2 * halo_set,
                smem_bytes=2 * halo_set + 2 * w_set)


def f32_descriptors(brick: int, tap: int, step: int, a_part: int, b_part: int, k: int):
    """(start, lbo, sbo) in bytes from the buffer's base of the A and B
    operands of one wgmma of the wgmma_f32 route at step `step` (chunk
    step // steps): the block's brick `brick`, tap `tap` (of the step's
    group), A's part and B's part (0 hi, 1 lo)."""
    p = f32_smem_plan(k)
    q, r = divmod(step, p["steps"])
    tl = tap - r * p["step_taps"]
    kx, ky = divmod(tap, k)
    a = ((q % 2) * p["halo_set"] + (a_part * F32_BRICKS + brick) * p["halo_bytes"]
         + (kx * p["h"] + ky) * 16, p["a_lbo"], p["a_sbo"])
    b = (p["w_offset"] + (step % 2) * p["w_set"] + (b_part * p["step_taps"] + tl) * F32_W_TAP,
         p["b_lbo"], p["b_sbo"])
    return a, b


def f32_halo_piece(i: int, c: int, q: int, k: int):
    """(brick, element offset into hz from the block's first brick, byte
    offset of the hi piece from its halo set's base, of the lo piece) of
    the halo's 16-byte load i of chunk q (zband_conv_tf32x3_sm90.cu::
    load_halo): 4-channel group i % 2 of pixel (i // 2) % h^2 of brick
    i // (2 h^2)."""
    p = f32_smem_plan(k)
    hp = p["h"] * p["h"]
    g, rest = i & 1, i >> 1
    brick, pix = divmod(rest, hp)
    off = brick * p["halo_bytes"] + g * p["a_lbo"] + pix * 16
    return (brick, (brick * hp + pix) * c + q * F32_CK + g * 4, off,
            F32_BRICKS * p["halo_bytes"] + off)


def f32_split_offset(tap: int, c: int, n: int, C: int, N: int) -> int:
    """Element offset, in the hi part, of wz[tap][c][n] in the split
    weight (zband_tf32x3_split_kernel): [tap][8-channel chunk][n][8]; the
    lo part follows at k^2 C N."""
    return ((tap * (C // F32_CK) + c // F32_CK) * N + n) * F32_CK + c % F32_CK


def f32_block_flag(tap: int, c: int, n: int, C: int, N: int) -> int:
    """Index of the flag of the 8 x 8 block of wz[tap] holding (c, n)
    (zband_tf32x3_split_kernel sets it where the block is not all zero)."""
    return (tap * (C // F32_CK) + c // F32_CK) * (N // 8) + n // 8


def f32_weight_piece(i: int, step: int, C: int, N: int, n0: int, k: int):
    """(element offset into the split weight, byte offset from the weight
    set's base, index of its block's flag) of the weight's 16-byte copy i
    of step `step` (zband_conv_tf32x3_sm90.cu::load_weights): part
    i // (256 step_taps), tap (i // 256) of the step's group, column
    (i % 256) // 2, 4-channel group i % 2. A copy whose flag is 0 is
    zero-filled."""
    p = f32_smem_plan(k)
    q, r = divmod(step, p["steps"])
    part, rest = divmod(i, p["step_taps"] * 256)
    tl, e = rest >> 8, rest & 255
    n, g = e >> 1, e & 1
    tap, c = r * p["step_taps"] + tl, q * F32_CK + 4 * g
    src = part * k * k * C * N + f32_split_offset(tap, c, n0 + n, C, N)
    return (src, (part * p["step_taps"] + tl) * F32_W_TAP + g * p["b_lbo"] + n * 16,
            f32_block_flag(tap, c, n0 + n, C, N))


def _launch(name: str, path: str, hz: torch.Tensor, *args):
    """Launch the named kernel on route `path`, on the current stream of
    hz's device; the op checks shapes, dtypes and contiguity and raises on
    what it cannot take, and on a shape the route does not take."""
    if hz.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {hz.device}")
    build()
    with torch.cuda.device(hz.device):
        stream = torch.cuda.current_stream().cuda_stream
        out = getattr(torch.ops.sps_torch, name)(hz, *args, ROUTES[path], stream)
    LAUNCHES[name] += 1
    ROUTE_LAUNCHES[name][path] += 1
    key = (name, path, tuple(hz.shape), tuple(args[0].shape))
    SHAPE_LAUNCHES[key] = SHAPE_LAUNCHES.get(key, 0) + 1
    return out


def zband_conv_ref(hz: torch.Tensor, wz: torch.Tensor, k: int, bs: int) -> torch.Tensor:
    """Plain version: the k*k slice-matmuls in f32 (pallas_conv._band_matmul_xla)."""
    acc = None
    for kx in range(k):
        for ky in range(k):
            a = hz[:, kx : kx + bs, ky : ky + bs, :].float()
            p = a @ wz[kx, ky].float()
            acc = p if acc is None else acc + p
    return acc.to(hz.dtype)


def zband_conv_fused_ref(hz, wz, scale, bias, occ, res=None, *, k: int, bs: int,
                         relu: bool = True) -> torch.Tensor:
    """Plain version of the fused conv (pallas_conv.zband_conv_fused's CPU branch)."""
    y = zband_conv_ref(hz, wz, k, bs).float()
    y = y * scale + bias
    if res is not None:
        y = y + res.float()
    if relu:
        y = torch.clamp_min(y, 0.0)
    return (y * occ.float()).to(hz.dtype)


def zband_conv_bwd(hz, wz, dout, k: int, bs: int, need_hz: bool = True, need_wz: bool = True):
    """The gradients (d_hz, d_wz) of zband_conv (None where not needed):
    d_hz[b, xo+kx, yo+ky] += dout[b, xo, yo] @ wz[kx, ky].T and
    d_wz[kx, ky] = sum_{b, xo, yo} hz[b, xo+kx, yo+ky]^T dout[b, xo, yo],
    in f32, cast to hz's and wz's dtypes."""
    d32 = dout.float()
    d_hz = d_wz = None
    if need_hz:
        acc = torch.zeros(hz.shape, dtype=torch.float32, device=hz.device)
        for kx in range(k):
            for ky in range(k):
                acc[:, kx : kx + bs, ky : ky + bs] += d32 @ wz[kx, ky].float().T
        d_hz = acc.to(hz.dtype)
    if need_wz:
        h32 = hz.float()
        d2 = d32.reshape(-1, d32.shape[-1])
        d_wz = torch.stack([
            torch.stack([h32[:, kx : kx + bs, ky : ky + bs].reshape(-1, hz.shape[-1]).T @ d2
                         for ky in range(k)])
            for kx in range(k)]).to(wz.dtype)
    return d_hz, d_wz


class _ZbandConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hz, wz, k, bs):
        ctx.save_for_backward(hz, wz)
        ctx.k, ctx.bs = k, bs
        if hz.device.type == "cpu":
            return zband_conv_ref(hz, wz, k, bs)
        return _launch("zband_conv", route(hz, wz, k, bs), hz, wz, k, bs)

    @staticmethod
    def backward(ctx, dout):
        hz, wz = ctx.saved_tensors
        d_hz, d_wz = zband_conv_bwd(hz, wz, dout, ctx.k, ctx.bs, *ctx.needs_input_grad[:2])
        return d_hz, d_wz, None, None


def zband_conv(hz: torch.Tensor, wz: torch.Tensor, k: int, bs: int) -> torch.Tensor:
    """VALID 2-D conv of the z-folded halo with the packed band kernel,
    differentiable in hz and wz.

    hz: (B, bs+k-1, bs+k-1, (bs+k-1)*TCin) assembled halo (brick.halo_z).
    wz: (k, k, (bs+k-1)*TCin, bs*TCout) from brick.pack_zband_kernel.
    Returns (B, bs, bs, bs*TCout) in hz.dtype."""
    return _ZbandConv.apply(hz, wz, k, bs)


def zband_conv_fused(hz, wz, scale, bias, occ, res=None, *, k: int, bs: int,
                     relu: bool = True) -> torch.Tensor:
    """Inference-only fused conv + BN affine (+res) (+relu) + mask; raises
    when an operand requires a gradient.

    scale/bias: (bs*TCout,) f32 z-tiled affine; occ: (B, bs, bs, bs*TCout)
    channel-repeated occupancy; res: optional residual of the same shape."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (hz, wz, scale, bias, occ, res)):
        raise RuntimeError("zband_conv_fused is inference-only: it has no gradient "
                           "(train with the unfused zband_conv and MaskedBatchNorm)")
    if hz.device.type == "cpu":
        return zband_conv_fused_ref(hz, wz, scale, bias, occ, res, k=k, bs=bs, relu=relu)
    path = route(hz, wz, k, bs, scale, bias, occ, res)
    return _launch("zband_conv_fused", path, hz, wz, scale, bias, occ, res, k, bs, relu)
