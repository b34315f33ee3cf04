"""Time diagnostic copies of the int8 brick conv's gather form beside the built one.

    python3 -m sps_torch.scripts.int8_variants SOURCE.cu [SOURCE.cu ...] [--variants asis,...]

Each SOURCE.cu is a version of sps_torch/csrc/brick_conv_int8.cu with
the plain C entry point sps_brick_conv_int8_gather: the ring schedule
("ring": one block a brick, the weight through a two-slot tap ring, as
of commit c6325b3, which `git show
c6325b3:sps_torch/csrc/brick_conv_int8.cu > build/int8_ring.cu` gives;
build/ is not committed), or the persistent one ("persistent":
brick_int8_gather_kernel, the weight resident, as built today). For each
source the script writes the copies named in --variants that its
schedule has, each one edit of the source text:

  asis       the source unchanged (both);
  noweight   the weight copy copies nothing (both);
  nohalo     the halo gather copies no piece (both);
  nomma      no mma.sync (both; ptxas then drops the unused ldmatrix
             loads too, so it reads as nomath);
  nomath     neither ldmatrix nor mma.sync (both);
  nobarrier  the two __syncthreads of each tap removed (ring);
  copyonly   neither math nor output stores: the copies, barriers and
             empty-slot stores alone (persistent; without the stores
             ptxas drops the math as dead code, so there is no copy
             with the math and without the stores);
  kz3        the three taps of a kz row unrolled at every C (persistent;
             built: where their fragments fit FRAGMENT_REGS, C <= 32);
  kfull      a tap's k steps unrolled at every C (persistent; built:
             where they fit FRAGMENT_REGS);
  lb3        launch bounds of three blocks an SM (85 registers) for the
             16-column passes at C <= 48 (persistent; built: two, 128);
  bufs2      two halo buffers wherever they fit (persistent).

noweight, nohalo, nomma, nomath, nobarrier and copyonly compute a wrong
output and serve for timing only. Each copy is compiled by nvcc for
sm_90a into a shared library under build/torch_ext/variants/ (one nvcc a
copy, all at once; ptxas's registers and spills printed, with the built
kernel's) and called through ctypes beside the built kernel
(sps_torch.ops.brick_conv_int8.brick_conv_int8_gather).

At each of the nine shapes of the shipping path's ten int8 convs
(chip_smoke.py phase 2b's operands: B the level's capacity, 90% of the
slots filled, nbr27 from grid_table) the built kernel and every asis
copy are held bit for bit against the plain version (the other copies'
bit-equality is printed), then each copy and the built kernel are timed
(bf16 out; least of 3 runs of 20 back-to-back calls, CUDA events) in the
order copies, built, built, copies, beside the call's bound. Prints one
line per shape, the per-scan sums and a JSON line of all times.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from sps_torch.ops import brick as bk
from sps_torch.ops import brick_conv_int8 as bi8
from sps_torch.ops import zband_conv as zc
from sps_torch.scripts.zband_sm90_variants import VARIANT_DIR, time_ms

# The shipping path's int8 convs (config/config.yaml, batch 1): (call,
# level, calls a scan, TCin, TCout), as chip_smoke.py's INT8_CALLS.
PATH_CALLS = [
    ("block8_0.conv1", 0, 1, 32, 16), ("block8_0.conv2", 0, 1, 16, 16),
    ("block1_0.conv1/conv2", 1, 2, 16, 16), ("block7_0.conv1", 1, 1, 48, 32),
    ("block7_0.conv2", 1, 1, 32, 32), ("block2_0.conv1", 2, 1, 16, 32),
    ("block2_0.conv2", 2, 1, 32, 32), ("block6_0.conv1", 2, 1, 96, 64),
    ("block6_0.conv2", 2, 1, 64, 64),
]
BRICKS = (11264, 3072, 1024)  # config.yaml's brick capacities at L0-L2, batch 1
PEAK_INT8_OPS, PEAK_HBM_BYTES = 1979e12, 3.35e12  # H100 SXM, dense

# For each schedule, name: [(text in its source, its replacement), ...];
# each text must occur exactly once. "ring": the gather form of commit
# c6325b3 (one block a brick, the weight through a two-slot tap ring);
# "persistent": the persistent-block form (brick_int8_gather_kernel, the
# weight resident).
EDITS = {
    "ring": {
        "asis": [],
        "noweight": [("  const int cg = C / 16;\n  for (int i = tid; i < NT * 8 * cg;",
                      "  const int cg = 0;\n  for (int i = tid; i < NT * 8 * cg;")],
        "nohalo": [("      cp_async16_zfill(halo_s + v * S + q * 16, src, r >= 0);\n", "")],
        "nomma": [("for (int j = 0; j < NT; ++j) mma_k32(acc[i][j], af, bf[j][0], bf[j][1]);",
                   "for (int j = 0; j < NT; ++j) {}"),
                  ("for (int j = 0; j < NT; ++j) mma_k16(acc[i][j], a0, a1, bf[j]);",
                   "for (int j = 0; j < NT; ++j) {}")],
        "nomath": [("      for (int ks = 0; ks < k32_steps; ++ks) {",
                    "      for (int ks = 0; ks < 0; ++ks) {"),
                   ("      if (k16_tail) {\n        const int c0 = k32_steps * 32;",
                    "      if (false) {\n        const int c0 = k32_steps * 32;")],
        "nobarrier": [("      cp_async_wait(last);\n      __syncthreads();\n",
                       "      cp_async_wait(last);\n"),
                      ("      __syncthreads();  // the slot is refilled two taps on\n", "")],
    },
    "persistent": {
        "asis": [],
        "noweight": [("for (int i = tid; i < TAPS * COLS * CG; i += THREADS) {",
                      "for (int i = tid; i < 0; i += THREADS) {")],
        "nohalo": [("    cp_async16_zfill(halo_s + v * S + q * 16, src, r >= 0);\n", "")],
        "nomma": [("for (int j = 0; j < NT; ++j) mma_k32(acc[i][j], af, bf[j][0], bf[j][1]);",
                   "for (int j = 0; j < NT; ++j) {}"),
                  ("for (int j = 0; j < NT; ++j) mma_k16(acc[i][j], a0, a1, bf[j]);",
                   "for (int j = 0; j < NT; ++j) {}")],
        "nomath": [("for (int kxy = 0; kxy < 9; ++kxy) {", "for (int kxy = 0; kxy < 0; ++kxy) {")],
        "copyonly": [("        store_brick<NT>(out, acc, scale, b, warp, lane, n0, N);\n", ""),
                     ("for (int kxy = 0; kxy < 9; ++kxy) {", "for (int kxy = 0; kxy < 0; ++kxy) {")],
        "kz3": [("  return 3 * tap_fragment_regs(c, nt) <= FRAGMENT_REGS ? 3 : 1;",
                 "  return 3;")],
        "kfull": [("  return tap_fragment_regs(c, nt) <= FRAGMENT_REGS && c >= 64 ? c / 32 : 1;",
                   "  return c >= 64 ? c / 32 : 1;")],
        "lb3": [("__global__ void __launch_bounds__(THREADS, 2)\n    brick_int8_gather_kernel",
                 "__global__ void __launch_bounds__(THREADS, NT == 2 && C <= 48 ? 3 : 2)\n"
                 "    brick_int8_gather_kernel")],
        "bufs2": [("(blocks_fit(two) >= 2 || blocks_fit(two) >= blocks_fit(one))", "true")],
    },
}


def schedule(text: str) -> str:
    """Which schedule's edits a source takes."""
    return "persistent" if "brick_int8_gather_kernel" in text else "ring"


def edited(text: str, name: str) -> str:
    for old, new in EDITS[schedule(text)][name]:
        if text.count(old) != 1:
            raise ValueError(f"{name}: the source does not hold {old!r} exactly once")
        text = text.replace(old, new)
    return text


def grid_table(b, num_bricks, rng, fill=0.7):
    """A (27, b) int32 neighbour table of a synthetic brick grid:
    num_bricks bricks at random cells of a cube of ~num_bricks / fill
    cells, rows in cell order (as the atlas numbers them), OFFS27 order;
    the slots past num_bricks are empty (all rows -1)."""
    side = max(1, round((num_bricks / fill) ** (1 / 3)))
    while side**3 < num_bricks:
        side += 1
    cells = np.sort(rng.choice(side**3, num_bricks, replace=False))
    lut = np.full((side + 2,) * 3, -1, np.int32)
    x, y, z = (a + 1 for a in np.unravel_index(cells, (side,) * 3))
    lut[x, y, z] = np.arange(num_bricks)
    nbr = np.full((27, b), -1, np.int32)
    for k, (dx, dy, dz) in enumerate(bk.OFFS27):
        nbr[k, :num_bricks] = lut[x + dx, y + dy, z + dz]
    return nbr


def gather_bound(b, present, c, n):
    """(operations, bytes, bound ms, bound_by) of a gather-form call: the
    codes of the bricks with a centre row read once, the weight, scale and
    table, the bf16 output of all b slots written once; the int8 products
    of the present bricks."""
    ops = 2 * present * 512 * 27 * c * n
    nbytes = present * 512 * c + 27 * c * n + 4 * n + 27 * b * 4 + b * 512 * n * 2
    t_ops, t_bytes = ops / PEAK_INT8_OPS, nbytes / PEAK_HBM_BYTES
    return ops, nbytes, max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def operands(b, num_bricks, c, n, seed):
    """Random codes (zero past num_bricks), a grid_table, a random weight
    in the quantizer's layout (a transposed view of (3, 3, 3, N, C)) and a
    scale, on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q8 = torch.randint(-127, 128, (b, 8, 8, 8, c), generator=g, device="cuda").to(torch.int8)
    q8[num_bricks:] = 0
    nbr = torch.from_numpy(grid_table(b, num_bricks, np.random.default_rng(seed))).cuda()
    w8 = torch.randint(-127, 128, (3, 3, 3, n, c), generator=g, device="cuda").to(torch.int8)
    scale = (0.5 + torch.rand(n, generator=g, device="cuda")) * 1e-4
    return q8, nbr, w8.transpose(-1, -2), scale


def build_copies(sources, names) -> dict:
    """Write and compile the copies of each source that its schedule has
    edits for (one nvcc each, all at once); return their C entry points,
    keyed "<source stem>_<edit>"."""
    VARIANT_DIR.mkdir(parents=True, exist_ok=True)
    cmds, sos = [], {}
    for source in sources:
        text = source.read_text()
        for name in names:
            if name not in EDITS[schedule(text)]:
                continue
            key = f"{source.stem}_{name}"
            cu = VARIANT_DIR / f"int8_{key}.cu"
            cu.write_text(edited(text, name))
            sos[key] = VARIANT_DIR / f"int8_{key}.so"
            cmds.append([zc._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                         "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-shared", str(cu), "-o",
                         str(sos[key])])
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    for name, p in zip(sos, procs):
        out = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc of {name} failed ({p.returncode}):\n{out}")
        for line in out.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)
    fns = {}
    for name, so in sos.items():
        fn = ctypes.CDLL(str(so)).sps_brick_conv_int8_gather
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def call_copy(fn, q8, nbr, w8, scale):
    b, n = nbr.shape[1], w8.shape[-1]
    wt = w8.transpose(-1, -2)  # (27, N, C) contiguous: the quantizer's layout
    out = torch.empty((b, 8, 8, 8, n), dtype=torch.bfloat16, device="cuda")
    err = fn(q8.data_ptr(), nbr.data_ptr(), wt.data_ptr(), scale.data_ptr(), out.data_ptr(), b,
             q8.shape[-1], n, 1, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"copy launch failed: {err}")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", type=Path, nargs="+",
                    help="versions of brick_conv_int8.cu (the ring schedule or the persistent one)")
    names = sorted({n for e in EDITS.values() for n in e})
    ap.add_argument("--variants", default=",".join(names),
                    help=f"comma-separated edits to build where a source has them (of "
                         f"{', '.join(names)})")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("int8_variants: no CUDA device")
    zc.build()
    entry = None
    for line in zc.build_log.splitlines():  # the built kernel's ptxas report
        if "Compiling entry" in line:
            entry = line if "brick_int8" in line else None
        if entry and ("registers" in line or "spill" in line or "(C75" in line
                      or line is entry):
            print(f"  ptxas built: {line.strip()}", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    fns = build_copies(args.sources, args.variants.split(","))
    times, sums = {}, {}
    for i, (where, level, per_scan, c, n) in enumerate(PATH_CALLS):
        b = BRICKS[level]
        nb = b - b // 10
        q8, nbr, w8, scale = operands(b, nb, c, n, seed=500 + i)
        want = bi8.brick_conv_int8_gather_ref(q8, nbr, w8, scale, torch.bfloat16).view(torch.int16)
        got = bi8.brick_conv_int8_gather(q8, nbr, w8, scale, torch.bfloat16).view(torch.int16)
        same = {name: bool(torch.equal(call_copy(fn, q8, nbr, w8, scale).view(torch.int16), want))
                for name, fn in fns.items()}
        print(f"check {where} B={b} ({nb} bricks) {c}->{n}: built bit-equal to plain "
              f"{bool(torch.equal(got, want))}; copies bit-equal to plain: {same}", flush=True)
        if not torch.equal(got, want) or not all(v for k, v in same.items() if k.endswith("_asis")):
            raise AssertionError(f"{where}: the built kernel or an asis copy differs from "
                                 "the plain version")
        del want, got
        t = {name: [time_ms(lambda: call_copy(fn, q8, nbr, w8, scale))] for name, fn in fns.items()}
        t["built"] = [time_ms(lambda: bi8.brick_conv_int8_gather(q8, nbr, w8, scale,
                                                                 torch.bfloat16))
                      for _ in range(2)]
        for name, fn in fns.items():
            t[name].append(time_ms(lambda: call_copy(fn, q8, nbr, w8, scale)))
        _, _, bound_ms, bound_by = gather_bound(b, nb, c, n)
        times[where] = dict(b=b, num_bricks=nb, c=c, n=n, calls_per_scan=per_scan,
                            bound_ms=bound_ms, bound_by=bound_by, ms=t)
        for name, v in t.items():
            sums[name] = sums.get(name, 0.0) + min(v) * per_scan
        sums["bound"] = sums.get("bound", 0.0) + bound_ms * per_scan
        print(f"{where:20s} L{level} {c:3d}->{n:2d} bound {bound_ms:.3f} ms ({bound_by}): "
              + ", ".join(f"{name} {min(v):.3f} ({', '.join(f'{x:.3f}' for x in v)})"
                          for name, v in t.items()) + f" [{card}]", flush=True)
        del q8, nbr, w8, scale
        torch.cuda.empty_cache()
    print("per scan (10 calls, least of each): "
          + ", ".join(f"{name} {v:.3f} ms" for name, v in sums.items()) + f" [{card}]",
          flush=True)
    print(json.dumps({"card": card, "per_scan_ms": sums, "calls": times}), flush=True)
    return times


if __name__ == "__main__":
    main()
