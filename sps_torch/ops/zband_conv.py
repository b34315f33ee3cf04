"""Z-band brick convolution: hand-written CUDA kernels and their plain versions.

Counterpart of sps_tpu/ops/pallas_conv.py. The z-band formulation
(ops/brick.py: fold_z / pack_zband_kernel / brick_conv_zband) turns a
stride-1 sparse 3-D conv over bricks into one VALID 2-D conv whose channel
axes carry the folded z dimension:

    out[b, xo, yo, n] = sum_{kx, ky < k} sum_c hz[b, xo+kx, yo+ky, c] * wz[kx, ky, c, n]

`zband_conv` returns it in hz's dtype; `zband_conv_fused` applies the
inference epilogue `occ * [relu](acc * scale + bias [+ res])` in f32
before the one cast.

On a CUDA tensor both launch the kernel in sps_torch/csrc/zband_conv.cu
through the ops that sps_torch/csrc/zband_conv_op.cpp registers
(torch.ops.sps_torch.*). The library is built at first use into
build/torch_ext/ (nvcc for sm_90a and the host compiler, started
together, then one link) and rebuilt when a source changes. A build or
launch failure raises. On a CPU tensor they compute the plain version
(`*_ref`), which the tests and chip_smoke.py also hold the kernel against.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = (CSRC / "zband_conv.cu", CSRC / "zband_conv_op.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_ext"

# One count per kernel launch; incremented only where the kernel launches.
LAUNCHES = {"zband_conv": 0, "zband_conv_fused": 0}

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
    """Compile (if a source changed) and load the kernels' library, which
    registers torch.ops.sps_torch.zband_conv and zband_conv_fused."""
    global _loaded, build_log
    if _loaded:
        return
    from torch.utils import cpp_extension

    h = hashlib.sha256(torch.__version__.encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    digest = h.hexdigest()[:16]
    so = BUILD_DIR / f"zband_conv_{digest}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        stem = BUILD_DIR / f"zband_conv_{digest}.{os.getpid()}"
        cu_o, op_o, tmp = (Path(f"{stem}{ext}") for ext in (".cu.o", ".op.o", ".tmp.so"))
        nvcc = _nvcc()
        abi = int(torch._C._GLIBCXX_USE_CXX11_ABI)
        build_log = _run([
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-c", str(SOURCES[0]), "-o", str(cu_o)],
            [os.environ.get("CXX", "g++"), "-std=c++17", "-O2", "-fPIC", "-w",
             f"-D_GLIBCXX_USE_CXX11_ABI={abi}",
             *(f"-I{p}" for p in cpp_extension.include_paths()),
             "-c", str(SOURCES[1]), "-o", str(op_o)],
        ])
        libdir = cpp_extension.library_paths()[0]
        build_log += _run([[nvcc, "-shared", str(cu_o), str(op_o), "-o", str(tmp),
                            f"-L{libdir}", "-lc10", "-ltorch", "-ltorch_cpu",
                            "-Xlinker", f"-rpath,{libdir}"]])
        os.replace(tmp, so)
        cu_o.unlink()
        op_o.unlink()
    torch.ops.load_library(str(so))
    _loaded = True


def _launch(name: str, hz: torch.Tensor, *args):
    """Launch the named kernel on the current stream of hz's device; the op
    checks shapes, dtypes and contiguity and raises on what it cannot take."""
    if hz.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {hz.device}")
    build()
    with torch.cuda.device(hz.device):
        stream = torch.cuda.current_stream().cuda_stream
        out = getattr(torch.ops.sps_torch, name)(hz, *args, stream)
    LAUNCHES[name] += 1
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


def zband_conv(hz: torch.Tensor, wz: torch.Tensor, k: int, bs: int) -> torch.Tensor:
    """VALID 2-D conv of the z-folded halo with the packed band kernel.

    hz: (B, bs+k-1, bs+k-1, (bs+k-1)*TCin) assembled halo (brick.halo_z).
    wz: (k, k, (bs+k-1)*TCin, bs*TCout) from brick.pack_zband_kernel.
    Returns (B, bs, bs, bs*TCout) in hz.dtype."""
    if hz.device.type == "cpu":
        return zband_conv_ref(hz, wz, k, bs)
    return _launch("zband_conv", hz, wz, k, bs)


def zband_conv_fused(hz, wz, scale, bias, occ, res=None, *, k: int, bs: int,
                     relu: bool = True) -> torch.Tensor:
    """Inference-only fused conv + BN affine (+res) (+relu) + mask.

    scale/bias: (bs*TCout,) f32 z-tiled affine; occ: (B, bs, bs, bs*TCout)
    channel-repeated occupancy; res: optional residual of the same shape."""
    if hz.device.type == "cpu":
        return zband_conv_fused_ref(hz, wz, scale, bias, occ, res, k=k, bs=bs, relu=relu)
    return _launch("zband_conv_fused", hz, wz, scale, bias, occ, res, k, bs, relu)
