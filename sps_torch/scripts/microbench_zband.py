"""Microbenchmark of the L0 z-band conv variants on the card.

Counterpart of scripts/microbench_pallas.py. The probe's Pallas kernel
(make_pallas_conv -> _zmm_kernel: the 9 banded matmuls of a k = 3 z-band
conv, whole weight resident, f32 accumulation, one cast) computes the
function of zband_conv at k = 3, so here it is the port's hand-written
zband_conv kernel launched at k = 3: in bf16 at the default widths its
wgmma route (sps_torch/csrc/zband_conv_sm90.cu), in f32 at the same
widths its wgmma_f32 route (sps_torch/csrc/zband_conv_tf32x3_sm90.cu, 3xTF32
on the tensor cores), at widths those routes do not take its wmma route
(sps_torch/csrc/zband_conv.cu).

Variants (the probe's names in brackets):
  halo         brick.brick_conv: halo + F.conv3d                 [xla-halo]
  zband        brick.brick_conv_zband: halo_z + the kernel       [xla-zband]
  zmm          halo_z + 9 banded torch.matmul, f32 across taps   [xla-zmm]
  kernel-zmm   halo_z + the kernel                               [pallas-zmm]
  kernel-conv  the kernel alone on a pre-assembled halo_z: its ceiling
                                                                 [pallas-conv]
  conv2d       F.conv2d on the same halo and band weight: a library
               yardstick, never on a path of the port
As in the probe, every variant but halo needs --tc == --tcout.

Each variant is timed with CUDA events around --iters back-to-back calls,
after two warm-up calls; the time is the least of three such runs divided
by --iters. The probe chained its calls inside one jit only to hide the
TPU's dispatch; on the card a call of a millisecond or more hides its own
launch. The probe's --g (the VMEM block of the Pallas grid) has no
counterpart: a CUDA block is fixed at 256 output rows (4 bricks) on the
wgmma routes and 128 on the wmma route. TFLOP/s
count dense FLOPs for halo and the band's FLOPs (zeros included) for the
other variants; K3's bound is max(band FLOPs / peak, bytes / HBM rate),
in f32 with the peak of three TF32 products a multiply-add on the tensor
cores (the wgmma_f32 route's arithmetic), and bound_fma_ms beside it: the
band FLOPs at the f32 peak outside the tensor cores.

Every output is held against the halo variant (relative max-abs error),
and kernel-conv also against the kernel's plain version zband_conv_ref on
the same halo; a failed build, launch or comparison raises. With
--device cpu the kernel's wrapper computes that plain version and nothing
is timed; on the card TF32 is set off, so f32 runs in full f32. K3's
launches are the growth of zband_conv.LAUNCHES["zband_conv"] over the run.

    python -m sps_torch.scripts.microbench_zband [--b 11264 --tc 16 --bs 8]
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch
import torch.nn.functional as F

from sps_torch.ops import brick as bk
from sps_torch.ops import zband_conv as zc
from sps_torch.structs import resolve_device

# Dense H100 SXM peaks (NVIDIA data sheet): bf16 tensor cores; f32 as
# 3xTF32 on the tensor cores (495 TFLOP/s TF32, three products a
# multiply-add); f32 outside the tensor cores (an FMA loop); HBM3.
PEAK_FLOPS = {"bf16": 989e12, "f32": 495e12 / 3}
PEAK_F32_FMA = 67e12
PEAK_HBM_BYTES = 3.35e12

# Bars: relative max-abs error max|got - want| / max|want| against the
# halo variant (bf16: inputs and outputs rounded to bf16; f32: the same
# f32 sums in another order, TF32 off); kernel-conv against its plain
# version as chip_smoke.py phase 2 holds the kernels: f32 elementwise
# within rtol / atol 1e-4, bf16 within 2e-2 of the output's max-abs.
REL_TOL = {"bf16": 2e-2, "f32": 1e-4}
F32_RTOL = F32_ATOL = 1e-4

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
VARIANTS = ("halo", "zband", "zmm", "kernel-zmm", "kernel-conv", "conv2d")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--b", type=int, default=11264, help="bricks")
    ap.add_argument("--tc", type=int, default=16, help="input channels (T*C)")
    ap.add_argument("--tcout", type=int, default=0, help="0 = same as --tc")
    ap.add_argument("--bs", type=int, default=8, help="brick side")
    ap.add_argument("--absent", type=float, default=0.35, help="share of absent neighbours")
    ap.add_argument("--skip", default="", help="csv variants to skip")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bf16")
    ap.add_argument("--iters", type=int, default=16, help="calls per timed run")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the card; cpu for the tests")
    args = ap.parse_args(argv)
    unknown = set(filter(None, args.skip.split(","))) - set(VARIANTS)
    if unknown:
        ap.error(f"--skip: unknown variants {sorted(unknown)}; known: {', '.join(VARIANTS)}")
    return args


def make_inputs(b, bs, tc, tco, absent, seed, dtype, device):
    """The probe's inputs (microbench_pallas.py:138-147), from one numpy
    generator: features (b, bs, bs, bs, tc) * 0.1, the (27, b) neighbour
    table with a share `absent` set to -1 and the centre row the brick
    itself, the dense 3x3x3 weight * 0.1 and all-ones occupancy."""
    rng = np.random.default_rng(seed)
    feats5 = (rng.standard_normal((b, bs, bs, bs, tc)) * 0.1).astype(np.float32)
    nbr = rng.integers(0, b, (27, b)).astype(np.int32)
    nbr[rng.random((27, b)) < absent] = -1
    nbr[13] = np.arange(b)
    w = (rng.standard_normal((3, 3, 3, tc, tco)) * 0.1).astype(np.float32)
    return dict(
        feats5=torch.from_numpy(feats5).to(device, dtype),
        nbr=torch.from_numpy(nbr).to(device),
        w=torch.from_numpy(w).to(device, dtype),
        occ5=torch.ones((b, bs, bs, bs, 1), dtype=dtype, device=device),
        occz=torch.ones((b, bs, bs, bs), dtype=dtype, device=device),
    )


def zmm(hz: torch.Tensor, wz: torch.Tensor, bs: int) -> torch.Tensor:
    """The 9 banded matmuls in hz's dtype, summed across taps in f32."""
    acc = None
    for kx in range(3):
        for ky in range(3):
            p = torch.matmul(hz[:, kx : kx + bs, ky : ky + bs, :], wz[kx, ky]).float()
            acc = p if acc is None else acc + p
    return acc.to(hz.dtype)


def time_ms(fn, iters: int) -> float:
    """Least CUDA-event time per call over 3 runs of `iters` calls, after
    two warm-up calls."""
    for _ in range(2):
        fn()
    best = math.inf
    for _ in range(3):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            fn()
        e1.record()
        e1.synchronize()
        best = min(best, e0.elapsed_time(e1) / iters)
    return best


def _errors(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max-abs error, max-abs of want), in f32."""
    return float((got.float() - want).abs().max()), float(want.abs().max())


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    b, bs, tc, dt = args.b, args.bs, args.tc, args.dtype
    tco = args.tcout or tc
    skip = set(filter(None, args.skip.split(",")))
    if tc != tco:
        skip |= set(VARIANTS) - {"halo"}
    dtype = DTYPES[dt]
    timed = dev.type == "cuda"
    if timed:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        zc.build()
    launches0 = zc.LAUNCHES["zband_conv"]

    x = make_inputs(b, bs, tc, tco, args.absent, args.seed, dtype, dev)
    feats5, nbr, w = x["feats5"], x["nbr"], x["w"]
    zf = bk.fold_z(feats5)
    wz = bk.pack_zband_kernel(w, bs, 1)
    hz = bk.halo_z(zf, nbr, 1, tc)  # pre-assembled, for kernel-conv and conv2d
    x_nchw, w_oihw = hz.permute(0, 3, 1, 2), wz.permute(3, 2, 0, 1)
    fns = {
        "halo": lambda: bk.fold_z(bk.brick_conv(feats5, nbr, w, x["occ5"], mask_out=False)),
        "zband": lambda: bk.brick_conv_zband(zf, nbr, w, x["occz"], mask_out=False),
        "zmm": lambda: zmm(bk.halo_z(zf, nbr, 1, tc), wz, bs),
        "kernel-zmm": lambda: zc.zband_conv(bk.halo_z(zf, nbr, 1, tc), wz, 3, bs),
        "kernel-conv": lambda: zc.zband_conv(hz, wz, 3, bs),
        "conv2d": lambda: F.conv2d(x_nchw, w_oihw).permute(0, 2, 3, 1),
    }

    m = b * bs * bs
    dense = 2 * m * bs * 27 * tc * tco
    band = 2 * m * 9 * hz.shape[-1] * wz.shape[-1]
    nbytes = (hz.numel() + wz.numel() + m * wz.shape[-1]) * hz.element_size()
    t_ops, t_bytes = band / PEAK_FLOPS[dt], nbytes / PEAK_HBM_BYTES
    res = {
        "device": torch.cuda.get_device_name(dev) if timed else "cpu", "dtype": dt,
        "b": b, "bs": bs, "tc": tc, "tcout": tco, "iters": args.iters,
        "hz": list(hz.shape), "wz": list(wz.shape),
        "route": zc.route(hz, wz, 3, bs) if timed else None, "gflop_dense": dense / 1e9,
        "gflop_band": band / 1e9, "gbytes": nbytes / 1e9,
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        **({"bound_fma_ms": max(band / PEAK_F32_FMA, t_bytes) * 1e3} if dt == "f32" else {}),
        "variants": {},
    }
    print(f"B={b} bs={bs} TC={tc}->{tco} {dt} on {res['device']} (kernel route "
          f"{res['route']}): dense {dense / 1e9:.1f} "
          f"GFLOP, band {band / 1e9:.1f} GFLOP, K3 bytes {nbytes / 1e9:.3f} GB; K3 bound "
          f"{res['bound_ms']:.3f} ms ({res['bound_by']}; {PEAK_FLOPS[dt] / 1e12:.0f} TFLOP/s, "
          f"{PEAK_HBM_BYTES / 1e12:.2f} TB/s)", flush=True)

    ref = None
    for name in VARIANTS:
        if name in skip:
            continue
        out = fns[name]()
        ms = time_ms(fns[name], args.iters) if timed else None
        flops = dense if name == "halo" else band
        r = {"ms": ms, "tflops": flops / ms / 1e9 if timed else None, "rel_err": None}
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{name}: non-finite output")
        if name == "halo":
            ref = out.float()
        elif ref is not None:
            err, scale = _errors(out, ref)
            r["rel_err"] = err / (scale or 1.0)
            if not r["rel_err"] <= REL_TOL[dt]:
                raise AssertionError(f"{name} vs halo: relative error {r['rel_err']:.3e} "
                                     f"above {REL_TOL[dt]:g}")
        if name == "kernel-conv":
            want = zc.zband_conv_ref(hz.float(), wz.float(), 3, bs)
            err, scale = _errors(out, want)
            if dt == "f32":
                ok = bool(((out - want).abs() <= F32_ATOL + F32_RTOL * want.abs()).all())
                bar = f"rtol {F32_RTOL:g} / atol {F32_ATOL:g}"
            else:
                ok = err <= REL_TOL[dt] * max(scale, 1e-6)
                bar = f"{REL_TOL[dt]:g} x max-abs"
            r.update(max_abs_err=err, out_max_abs=scale, bar=bar)
            if not ok:
                raise AssertionError(f"kernel-conv vs zband_conv_ref: max-abs error {err:.3e} "
                                     f"(out max-abs {scale:.3e}) outside {bar}")
            del want
            res["plain_ms"] = (time_ms(lambda: zc.zband_conv_ref(hz, wz, 3, bs), args.iters)
                               if timed else None)
        res["variants"][name] = r
        del out
        when = f"{ms:9.3f} ms ({r['tflops']:6.1f} TFLOP/s)" if timed else "not timed (cpu)"
        err = "" if r["rel_err"] is None else f"  rel err vs halo {r['rel_err']:.3e}"
        print(f"  {name:12s} {when}{err}", flush=True)
    if "kernel-conv" in res["variants"]:
        kc = res["variants"]["kernel-conv"]
        plain = f"{res['plain_ms']:.3f} ms" if timed else "not timed (cpu)"
        print(f"  kernel-conv vs zband_conv_ref: max-abs error {kc['max_abs_err']:.3e} "
              f"(out max-abs {kc['out_max_abs']:.3e}; {kc['bar']}); plain version {plain}",
              flush=True)
    res["launches"] = zc.LAUNCHES["zband_conv"] - launches0
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
