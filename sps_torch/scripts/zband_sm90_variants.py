"""Time variants of a wgmma z-band kernel beside the built one, on the card.

    python3 -m sps_torch.scripts.zband_sm90_variants [VARIANT.cu ...] [--sweep]
    python3 -m sps_torch.scripts.zband_sm90_variants --k5 [VARIANT.cu ...]
    python3 -m sps_torch.scripts.zband_sm90_variants --k5-wide [VARIANT.cu ...]
    python3 -m sps_torch.scripts.zband_sm90_variants --f32 [VARIANT.cu ...]

Each VARIANT.cu is a version of sps_torch/csrc/zband_conv_sm90.cu (an
earlier revision, or a trial copy) with the same plain C entry point
sps_zband_conv_sm90; with --k5, of zband_conv_k5_sm90.cu with its entry
point sps_zband_conv_k5_sm90. Each is compiled by nvcc for sm_90a (with
sps_torch/csrc on the include path) into a shared library under
build/torch_ext/variants/ and called through ctypes beside the built
kernel (the wgmma, wgmma_k5 or wgmma_k5_wide route of sps_torch.ops.zband_conv).

First every kernel is held against the plain version (within 2e-2 of the
output's max-abs, bf16 against f32) at ragged and full shapes, and each
variant's output is compared bit for bit with the built kernel's. Then
each is timed at the L0 shapes (B = 11264): unfused at C = 32, K3 at
TC 16 (C = 160) and C = 320, block8_0.conv1, block8_0.conv2 (with
residual) and K3 at TC 32 (C = 320, N = 256). A time is the least of 3
runs of 20 back-to-back calls (CUDA events), taken in the order
variants, built, built, variants. --sweep also times the built kernel
unfused over C = 32, 64, 160, 320, which splits its time into a fixed
part and a part per 16-channel chunk. With --k5 the shapes are the
stem's (k = 5, h = 12): checks at ragged B, C 8/16/24 and N 128/256 with
random weights, then the stem (B = 11264, C = 24, N = 128) and its
N = 256 form timed. With --f32 the copies are of zband_conv_tf32x3_sm90.cu
(entry point sps_zband_conv_tf32x3_sm90, the wgmma_f32 route), the
operands f32, the bar rtol / atol 1e-4 against the plain version, and the
shapes the route takes: checks at ragged B for k = 3 (fused and not) and
the k = 5 stem, then the stem, K3 (C = 160), block8_0.conv1 and
block8_0.conv2 timed with band-packed weights (the kernel skips their
all-zero 8 x 8 blocks). With --k5-wide the copies are of
zband_conv_k5_wide_sm90.cu (entry point sps_zband_conv_k5_wide_sm90, the
wgmma_k5_wide route: the C = 48 stem of DIST_FEATURE), the row-staged
layout that the kernel's weight-stationary one was chosen over
(sps_torch/scripts/variants/k5_wide_rowstaged.cu) is always among them,
every variant is also held against the plain version, F.conv2d is timed
once after the built kernel, and the checks run at ragged B,
N 128 and 256, band-packed and random weights; then the stem
(B = 11264, C = 48, N = 128) is timed with its band-packed weight (the
kernel skips the all-zero blocks it finds there) and with a random one
(nothing to skip), beside F.conv2d on the same operands. Prints one line
per shape and a JSON line of all times.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
from pathlib import Path

import torch

from sps_torch.ops import brick as bk
from sps_torch.ops import zband_conv as zc

VARIANT_DIR = zc.BUILD_DIR / "variants"
K5W_ROWSTAGED = Path(__file__).resolve().parent / "variants" / "k5_wide_rowstaged.cu"
CHECKS = [  # (B, C, N, fused, res): ragged B, two column tiles, a full shape
    (1, 32, 128, True, True), (3, 64, 256, False, False), (5, 160, 128, True, False),
    (535, 32, 256, True, True), (11264, 320, 128, True, False),
]
TIMED = {  # name: (C, N, fused, res) at B = 11264
    "C32 unfused": (32, 128, False, False), "K3 TC16": (160, 128, False, False),
    "C320 unfused": (320, 128, False, False), "block8_0.conv1": (320, 128, True, False),
    "block8_0.conv2": (160, 128, True, True), "K3 TC32": (320, 256, False, False),
}
# --k5: the stem's kernel, unfused only.
CHECKS_K5 = [(1, 24, 128, False, False), (3, 16, 256, False, False), (5, 8, 128, False, False),
             (535, 24, 256, False, False), (11264, 24, 128, False, False)]
TIMED_K5 = {"stem": (24, 128, False, False), "stem N=256": (24, 256, False, False)}
# --k5-wide: (B, C, N, band-packed) checks and (C, N, band-packed) timed shapes.
CHECKS_K5W = [(1, 48, 128, True), (3, 48, 256, False), (5, 48, 128, True),
              (7, 48, 128, False), (535, 48, 256, True), (11263, 48, 128, True)]
TIMED_K5W = {"dist stem": (48, 128, True), "dist stem random wz": (48, 128, False)}
# --f32: (B, C, N, fused, res, k) checks and (C, N, fused, res, k) timed shapes.
CHECKS_F32 = [(1, 32, 128, True, True, 3), (3, 64, 256, False, False, 3),
              (5, 160, 128, True, False, 3), (5, 24, 128, False, False, 5),
              (535, 32, 256, True, True, 3), (11264, 320, 128, True, False, 3)]
TIMED_F32 = {"stem": (24, 128, False, False, 5), "K3 TC16": (160, 128, False, False, 3),
             "block8_0.conv1": (320, 128, True, False, 3),
             "block8_0.conv2": (160, 128, True, True, 3)}


def load_variant(src: Path, k: int = 3, f32: bool = False, wide: bool = False):
    """Compile one variant and return its C entry point."""
    VARIANT_DIR.mkdir(parents=True, exist_ok=True)
    so = VARIANT_DIR / f"{src.stem}.so"
    subprocess.run([zc._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-Xcompiler", "-fPIC", "-Xptxas", "-v", f"-I{zc.CSRC}", "-shared", str(src),
                    "-o", str(so)], check=True)
    lib = ctypes.CDLL(str(so))
    if f32:
        fn = lib.sps_zband_conv_tf32x3_sm90
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    elif k == 5:
        fn = lib.sps_zband_conv_k5_wide_sm90 if wide else lib.sps_zband_conv_k5_sm90
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
    else:
        fn = lib.sps_zband_conv_sm90
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def call_variant(fn, hz, wz, ep):
    b, k, c, n = hz.shape[0], wz.shape[0], hz.shape[-1], wz.shape[-1]
    out = torch.empty((b, 8, 8, n), dtype=hz.dtype, device=hz.device)
    stream = torch.cuda.current_stream().cuda_stream
    if hz.dtype == torch.float32:
        ptrs = [None if t is None else t.data_ptr() for t in (ep or (None,) * 4)]
        wsplit = torch.empty(2 * wz.numel() + wz.numel() // 64, dtype=torch.float32,
                             device=hz.device)
        err = fn(int(ep is not None), hz.data_ptr(), wz.data_ptr(), *ptrs, out.data_ptr(),
                 wsplit.data_ptr(), b, k, 8, c, n, 1, stream)
    elif k == 5:
        err = fn(hz.data_ptr(), wz.data_ptr(), out.data_ptr(), b, 5, 8, c, n, stream)
    else:
        ptrs = [None if t is None else t.data_ptr() for t in (ep or (None,) * 4)]
        err = fn(int(ep is not None), hz.data_ptr(), wz.data_ptr(), *ptrs, out.data_ptr(), b, 3,
                 8, c, n, 1, stream)
    if err != 0:
        raise RuntimeError(f"variant launch failed: {err}")
    return out


def call_built(hz, wz, ep):
    k = wz.shape[0]
    if ep is None:
        return zc.zband_conv(hz, wz, k, 8)
    return zc.zband_conv_fused(hz, wz, *ep, k=k, bs=8)


def make(g, b, c, n, fused, res, k=3, dtype=torch.bfloat16, band=False):
    """Seeded operands in `dtype` (scale and bias f32), as chip_smoke.py's
    make_case draws them (at k = 5 with a random weight that is not
    band-packed); with `band`, a band-packed weight (brick.pack_zband_kernel
    of a random 3-D kernel with C / h input and N / 8 output channels)."""
    h = 8 + k - 1
    hz = torch.rand((b, h, h, c), generator=g, device="cuda").to(dtype)
    if band:
        w = torch.randn((k, k, k, c // h, n // 8), generator=g, device="cuda")
        wz = bk.pack_zband_kernel(w * (2.0 / (k**3 * c // h)) ** 0.5, 8, k // 2).to(dtype)
    else:
        wz = (torch.randn((k, k, c, n), generator=g, device="cuda")
              * (2.0 / (k * k * c * k / h)) ** 0.5).to(dtype)
    if not fused:
        return hz, wz, None
    occ = (torch.rand((b, 8, 8, n), generator=g, device="cuda") < 0.5).to(dtype)
    r = (torch.randn((b, 8, 8, n), generator=g, device="cuda") * occ).to(dtype) if res else None
    return hz, wz, (0.5 + torch.rand(n, generator=g, device="cuda"),
                    0.1 * torch.randn(n, generator=g, device="cuda"), occ, r)


def time_ms(fn, iters=20) -> float:
    for _ in range(3):
        fn()
    best = math.inf
    for _ in range(3):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            fn()
        e1.record()
        e1.synchronize()
        best = min(best, e0.elapsed_time(e1) / iters)
    return best


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", type=Path,
                    help="copies of zband_conv_sm90.cu (zband_conv_k5_sm90.cu with --k5)")
    ap.add_argument("--sweep", action="store_true", help="time the built kernel over C")
    ap.add_argument("--k5", action="store_true", help="the k = 5 stem kernel's variants")
    ap.add_argument("--f32", action="store_true", help="the wgmma_f32 kernel's variants")
    ap.add_argument("--k5-wide", action="store_true",
                    help="the wgmma_k5_wide kernel's variants (the C = 48 stem)")
    args = ap.parse_args(argv)
    if args.k5_wide:
        return main_k5_wide(args.variants)
    k = 5 if args.k5 else 3
    dtype = torch.float32 if args.f32 else torch.bfloat16
    if args.f32:
        checks, timed = CHECKS_F32, TIMED_F32
    else:
        checks = [(*c, k) for c in (CHECKS_K5 if args.k5 else CHECKS)]
        timed = {name: (*v, k) for name, v in (TIMED_K5 if args.k5 else TIMED).items()}
    if not torch.cuda.is_available():
        raise SystemExit("zband_sm90_variants: no CUDA device")
    zc.build()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    fns = {src.stem: load_variant(src, k, args.f32) for src in args.variants}
    g = torch.Generator(device="cuda").manual_seed(0)
    for b, c, n, fused, res, k in checks:
        hz, wz, ep = make(g, b, c, n, fused, res, k, dtype)
        got = call_built(hz, wz, ep)
        f32 = [None if t is None else t.float() for t in (ep or ())]
        want = (zc.zband_conv_fused_ref(hz.float(), wz.float(), *f32, k=k, bs=8) if ep
                else zc.zband_conv_ref(hz.float(), wz.float(), k, 8))
        err, top = float((got.float() - want).abs().max()), float(want.abs().max())
        same = {name: bool(torch.equal(call_variant(fn, hz, wz, ep), got))
                for name, fn in fns.items()}
        print(f"check k={k} B={b} C={c} N={n} fused={fused} res={res}: max-abs error "
              f"{err:.3e} (out max-abs {top:.3e}); bit-equal to the built kernel: {same}",
              flush=True)
        if args.f32:
            for name, fn in fns.items():
                e = (call_variant(fn, hz, wz, ep) - want).abs()
                if not bool((e <= 1e-4 + 1e-4 * want.abs()).all()):
                    raise AssertionError(f"{name} disagrees with the plain version")
            ok = bool(((got - want).abs() <= 1e-4 + 1e-4 * want.abs()).all())
        else:
            ok = err <= 2e-2 * top
        if not ok:
            raise AssertionError("the built kernel disagrees with the plain version")
    times = {}
    for shape, (c, n, fused, res, k) in timed.items():
        hz, wz, ep = make(g, 11264, c, n, fused, res, k, dtype, band=args.f32)
        t = {name: [time_ms(lambda: call_variant(fn, hz, wz, ep))] for name, fn in fns.items()}
        t["built"] = [time_ms(lambda: call_built(hz, wz, ep)) for _ in range(2)]
        for name, fn in fns.items():
            t[name].append(time_ms(lambda: call_variant(fn, hz, wz, ep)))
        times[shape] = t
        print(f"{shape:15s} " + ", ".join(f"{name} {min(v):.3f} ms ({', '.join(f'{x:.3f}' for x in v)})"
                                          for name, v in t.items()), flush=True)
        del hz, wz, ep
    if args.sweep:
        times["sweep"] = {}
        for c in (32, 64, 160, 320):
            hz, wz, _ = make(g, 11264, c, 128, False, False, 3, dtype)
            times["sweep"][c] = time_ms(lambda: call_built(hz, wz, None))
            print(f"sweep C={c:3d} ({c // zc.SM90_CK} chunks): built {times['sweep'][c]:.3f} ms",
                  flush=True)
    print(json.dumps({"card": card, "times": times}), flush=True)
    return times


def main_k5_wide(variants) -> dict:
    """--k5-wide: the wgmma_k5_wide kernel and its variants, each held against
    the plain version, then timed beside each other and F.conv2d."""
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        raise SystemExit("zband_sm90_variants: no CUDA device")
    zc.build()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    fns = {src.stem: load_variant(src, 5, wide=True) for src in [K5W_ROWSTAGED, *variants]}
    g = torch.Generator(device="cuda").manual_seed(0)
    for b, c, n, band in CHECKS_K5W:
        hz, wz, _ = make(g, b, c, n, False, False, 5, band=band)
        if zc.route(hz, wz, 5, 8) != "wgmma_k5_wide":
            raise AssertionError(f"C={c} N={n}: route {zc.route(hz, wz, 5, 8)}")
        want = zc.zband_conv_ref(hz.float(), wz.float(), 5, 8)
        top = float(want.abs().max())
        outs = {"built": call_built(hz, wz, None),
                **{name: call_variant(fn, hz, wz, None) for name, fn in fns.items()}}
        errs = {name: float((o.float() - want).abs().max()) for name, o in outs.items()}
        same = {name: bool(torch.equal(o, outs["built"])) for name, o in outs.items()}
        print(f"check k=5 B={b} C={c} N={n} {'band' if band else 'random'} wz: max-abs error "
              f"{errs} (out max-abs {top:.3e}); bit-equal to the built kernel: {same}", flush=True)
        if max(errs.values()) > 2e-2 * top:
            raise AssertionError("a kernel disagrees with the plain version")
    times = {}
    for shape, (c, n, band) in TIMED_K5W.items():
        hz, wz, _ = make(g, 11264, c, n, False, False, 5, band=band)
        x_nchw, w_oihw = hz.permute(0, 3, 1, 2), wz.permute(3, 2, 0, 1)
        t = {name: [time_ms(lambda: call_variant(fn, hz, wz, None))] for name, fn in fns.items()}
        t["built"] = [time_ms(lambda: call_built(hz, wz, None)) for _ in range(2)]
        t["F.conv2d"] = [time_ms(lambda: F.conv2d(x_nchw, w_oihw))]
        for name, fn in fns.items():
            t[name].append(time_ms(lambda: call_variant(fn, hz, wz, None)))
        times[shape] = t
        print(f"{shape:20s} " + ", ".join(
            f"{name} {min(v):.3f} ms ({', '.join(f'{x:.3f}' for x in v)})" for name, v in t.items()),
            flush=True)
        del hz, wz, x_nchw, w_oihw
    print(json.dumps({"card": card, "times": times}), flush=True)
    return times


if __name__ == "__main__":
    main()
