#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (sps_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (and exits non-zero) on failure:
  1. build  - compile the CUDA kernels from sps_torch/csrc with nvcc, one
              process per source, all at once (into build/torch_ext/), load
              them and print ptxas's registers, spills and wgmma
              serialization notes per kernel (the int8 gather form must
              show at most 128 registers, no spill and no C75xx note);
  2. kernels - hold each kernel against its plain PyTorch version on the
              card, at small shapes, at ragged shapes of the wgmma route
              (zband_conv_sm90.cu: B 1, 3, 5; TCin 16, 32; N 128, 256; with
              and without residual and relu), at ragged shapes of the
              wgmma_k5 route (zband_conv_k5_sm90.cu: B 1, 3, 5; the stem's
              band-packed weight and random non-band weights; C 24, 16, 8;
              N 128, 256), at ragged shapes of the wgmma_f32 route
              (zband_conv_tf32x3_sm90.cu, f32 on 3xTF32 wgmma: B 1, 3, 5;
              k 3 and the k = 5 stem) and at the main path's full-width
              shapes, in f32 (TF32 off; rtol/atol 1e-4) and bf16 (max error
              within 2e-2 of the output's max-abs); print each call's
              route; time the kernel, the WMMA kernel on the same operands
              where the call takes a wgmma route (also at K3's shape), the
              plain version and F.conv2d (CUDA events, median of 20), in
              bf16 and, on the wgmma_f32 route, in f32 at the stem, both
              block8 convs and K3 beside both f32 bounds (3xTF32 on the
              tensor cores; an FMA loop at the f32 peak); and the C = 48
              stem of DIST_FEATURE on the wgmma_k5_wide route
              (zband_conv_k5_wide_sm90.cu, bf16: B 1, 7, 11263, 3, 5; N 128,
              256; band-packed and random weights; then full
              width timed beside the WMMA kernel on the same operands, its
              bound, the floor of the work it executes, the plain version
              and F.conv2d) and in f32 on wgmma_f32 (ragged B 7, 1 and full
              width, timed as the other f32 calls);
              Then the int8 brick conv (brick_conv_int8.cu) against its
              plain version bit for bit, bf16 and f32 outputs, at the nine
              shapes of the shipping path's ten int8 convs (full B), at
              ragged B = 1, 3, 5, on a zero input and on all-+-127 codes
              (the largest |acc|); each full shape timed (kernel, plain
              version, and the bf16 F.conv3d that the int8-off halo path
              runs on the same halo shape) beside its bound; a shape the
              kernel does not take must raise. Then its gather form (the
              kernel gathers each brick's halo through nbr27) bit for bit
              against its plain version, bf16 and f32, at the nine shapes
              with nbr27 from a synthetic brick grid (~35% of neighbours
              absent, ~10% of the slots past num_bricks), at ragged
              B = 1, 3, 5, with every neighbour absent, with every slot
              empty and on +-127 codes, and, for its persistent blocks,
              at B = 1001 (no multiple of the grid), B = 100 (below the
              grid) and B = 600 with every slot empty; wrapper and op
              must raise on what they refuse; each full shape timed
              (gather form, the halo() assembly plus the halo form, the
              halo form alone, and the int8-off path's bf16 halo() plus
              F.conv3d, all on the same codes and table) beside its
              bound;
  3. parity - the port's streaming filter on the card against the same
              filter on the CPU (the path the CPU tests hold against
              sps_tpu), f32, small config, full MinkUNet14 width: the
              zband configuration and the shipping options (CONV_MODE
              halo, HEAD_FOLD) with INT8 off at rtol 1e-3 / atol 1e-4, then
              with INT8 on at the int8 tolerance (check_int8_parity);
  4. path   - the zband path: StreamingFilter at config/config.yaml with
              CONV_MODE zband, ZBAND_LEVELS 1, INT8 off (full MinkUNet14
              width, full capacities, bf16, TOPO_EVERY 8), seeded random
              weights, 10 BLT-scale synthetic scans at 0.2 m steps; checks
              overflow, scores and launch counts per route (both block8
              convs on wgmma, the k = 5 stem on wgmma_k5, no int8 conv),
              prints latencies; then the same scans in f32 (the stem and
              both block8 convs on wgmma_f32, counted): max |dscore| and
              keep flips of bf16 against f32 (bound 0.05);
  5. microbench - K3's path: sps_torch/scripts/microbench_zband.py at
              B = 11264, bs = 8, TC = 16, bf16 then f32 (TF32 off): every
              L0 conv variant timed and held against the halo variant, the
              zband_conv kernel at k = 3 against its plain version, K3's
              launches counted over the bf16 run, all on the wgmma route
              (the f32 run's on wgmma_f32);
  6. shipping - the shipping path: StreamingFilter at config/config.yaml
              as shipped (CONV_MODE halo, INT8, HEAD_FOLD, bf16), the same
              weights and scans as phase 4 and its checks; the gather form
              of brick_conv_int8 launched 10 times a scan, its halo form
              and the z-band kernels never, and 10 fewer halo() calls a
              scan than the int8-off twin makes; num_bricks per level of
              the last rebuild; a rebuild and a reuse scan with no host
              sync (sync debug mode "error"); then its int8-off twin
              (bound 0.1 on |dscore| against it) and that twin in f32
              (bound 0.05 against the twin).
  7. loop   - the localization loop on the shipping path (phase_loop):
              LocalizationLoop at config/config.yaml as shipped with the
              same weights and scans (their truth is the identity), refine
              on, then off; the first two calls seeded with prior=, the
              reuse calls under sync debug mode "error"; 10 launches of the
              int8 gather form a filter pass; pose error < 0.05 m; p50,
              peak memory, and a profile of 8 scans (kernel time and
              launches a scan, filter / ICP split by the sps.loop.* ranges);
  8. trained - trained localization (phase_trained): the movers sequences
              generated by the port, ckpt_loc_movers_v2 from
              sps_torch/assets/ckpt_loc_movers_v2.npz under
              config_loc_movers_v2.yaml at epsilon 0.99, run_localization
              with raw, sps and oracle (prior odom, init_noise 0.05,
              refine) on 20220629 and 20220629_clean, held against
              sps_tpu's pin (sps_torch/assets/loc_movers_v2_pin.npz): each
              scan's translation within 3 mm, ATE within 1 mm and kept
              fraction within 0.005 of the pin's; sps's ATE below raw's on
              20220629; then phase 11 on the same data;
  9. offline - (9a) the int8 parity gate of tests/test_int8_parity.py on
              the trained v1 checkpoint (sps_torch/assets/ckpt_loc_movers.npz,
              config_loc_movers.yaml, epsilon 0.9, six scans of 20220608
              generated alone): StreamingFilter float, INT8 and INT8 +
              HEAD_FOLD, TP/FP/FN summed over the scans; float uIoU > 0.5,
              each int8 run within 0.005 of it, each within 0.005 of
              sps_tpu's pin (int8_parity_pin.npz), 10 gather-form launches a
              scan in the int8 runs and none in the float run; (9b)
              eval.predict_sequence on 20220629 of the movers data with v1
              (config_loc_movers.yaml) and v2 (config_loc_movers_v2.yaml,
              the distance feature), each mean metric within 0.005 of
              sps_tpu's pin (predict_pin.npz) and the same per-scan overflow
              flags (the 25.6 m atlas window does not hold a movers scan);
              (9c) predict_sequence at config/config.yaml as shipped on phase
              6's scans and map written to disk under build/blt (the dense
              join at JOIN_EXTENT, SUBMAP_POINTS 131072): 10 gather launches
              a scan, finite scores, no capacity overflow, int8 within 0.1 of
              its int8-off twin, ms a scan and peak memory; (9d)
              stream.replay.replay_sequence over the same sequence, every
              filter call under sync debug mode "error", its scores and keeps
              bit-equal to a fresh StreamingFilter called directly.
  10. train - (10a) zband_conv under autograd with the kernel forward
              against autograd through its plain version (outputs, d_hz,
              d_wz) at the stem's shape (wgmma_k5, B = the batch-2 L0
              capacity), a block8 shape (wgmma) and a ragged f32 shape
              (wmma), the kernel forward and the plain backward timed; the
              halo / halo_z backward (the gather-transpose) on the card
              against the CPU at pads 1 and 2; zband_conv_fused refusing a
              gradient; (10b) sps_tpu's pinned training step
              (sps_torch/assets/train_step_pin.npz) on the card in f32, each
              record (MSE, STEM_ZBAND, BCE, STABLE_WEIGHT), at the CPU test's
              tolerances; (10c) train.fit at config/config.yaml as shipped
              (full width, atlas, halo, bf16, batch 2, augmentation) on phase
              6's scans written to disk as config.yaml's splits (8 train, 2
              val): an epoch and a validation, a resume for one step,
              predict_sequence from best; step p50, peak memory, losses,
              overflow, no zband_conv_fused or int8 launch in any training
              step; a profile of two steps (kernel time and launches a
              step); 8 steps on one batch without augmentation (LR 1e-3),
              whose loss must fall; (10d) three training steps with
              STEM_ZBAND (one wgmma_k5 launch each), the streaming filter at
              config.yaml + STEM_ZBAND on phase 6's scans (one wgmma_k5
              launch a scan, scores within 0.05 of phase 6's), the stem's
              times (halo() + cuDNN conv3d against halo_z + the kernel) and
              both filters' kernel time a scan.
  11. baselines - (phase_baselines, run after phase 8 on its movers data)
              the round-5 baseline checkpoints (sps_torch/assets/
              baselines_r5_*.npz): MOS4D (bf16, as sps_tpu), MapMOS and LTS
              (f32, TF32 off) on 20220629's first scan against sps_tpu's
              outputs in loc_baselines_pin.npz; run_localization with mask,
              mos4d, mapmos and lts (phase 8's protocol) on 20220629 and
              20220629_clean against the pin at phase 8's tolerances, MOS4D
              pinned to sps_tpu's keep masks (its registration is chaotic
              in them; its own decisions held at every call), then MOS4D's
              free run (ATE within 0.02 m of the pin's); p50 ms a scan and
              peak memory per run; no kernel of sps_torch/csrc launched on
              this path.
  12. hash  - the hash engines (sps_tpu's defaults and config_small.yaml's
              gather engine): (12a) config/config_small.yaml as shipped
              (ENGINE gather, JOIN_MODE hash, f32, TF32 off, full width,
              phase 3's world and weights): the first scan's voxelize hash
              table, point2voxel and the hash join's mask bit-equal on the
              card, on the CPU and in sps_tpu's pin
              (sps_torch/assets/hash_engines_pin.npz), assemble_batch card vs
              CPU bit-equal, StreamingFilter card vs CPU and vs the pin (rtol
              1e-3 / atol 1e-4, equal stats), then fit (4 steps),
              predict_sequence, replay_sequence and run_localization on that
              world written to disk and 6 steps on a fixed batch whose loss
              must fall; (12b) the gather engine (VOXELS raised where the
              scans need more, logged), the brick engine (side 8, region) and
              the atlas engine (halo) on phase 6's first 3 scans, f32, the
              rebuild program: no overflow, scores within rtol 1e-3 / atol
              1e-4 of the atlas engine's; (12c) bf16 at BLT scale over phase
              6's ten scans: the gather engine, the brick engine in region
              mode with INT8 off and on: p50, host syncs a scan, peak
              memory, launch counts (21 launches of the int8 gather form a
              scan with INT8 on, none else), a profile of 4 scans (kernel ms
              and launches a scan, the sps.hash.build / sps.hash.lookup
              ranges, sps.stage.topo and sps.model), the probe loops' rounds in one scan by kind, and with
              INT8 on every int8 conv of a scan bit for bit against its plain
              version.
  13. zband levels and atlas forms - (13a) phase 4's path at
              ZBAND_LEVELS 2 and 3 (6 / 10 fused convs a scan on wgmma, the
              stem on wgmma_k5), scores within 0.05 of phase 4's, kernel ms
              and launches a scan with --profile; K2 at the seven L1 / L2
              shapes those levels fold (B 3072 / 1024, N 128-512), its
              launches at each shape in the ZBAND_LEVELS 3 run counted and
              held to the table, against its plain version and timed beside
              F.conv2d with its bound (band zeros counted, and without); (13b)
              the all-brick pyramid (ROW_FROM 0) and the hybrid form (ROW_FROM
              2 at side 8, VOXELS raised where a scan needs more rows) at
              config.yaml in f32 on phase 6's first 3 scans, from each scan's
              grid built on the CPU: tables card = CPU, scores within 1e-5 of
              the CPU's and 1e-4 of the aliased pyramid's, no overflow; then
              each form's StreamingFilter on the card (its own voxelization
              and rebuild, TOPO_EVERY 0) within 1e-4 of the aliased filter's,
              no overflow.
  14. sp / dp - (14a) one rank on NCCL: the sp filter at config.yaml
              bit-equal to the filter without a group, the dp step against
              the step without a group (no further apart than two runs of
              it); (14b) two ranks spawned on the one card over gloo (NCCL
              refuses two ranks on one card; collectives staged through the
              host, counted): the sp filter at config.yaml as shipped (INT8)
              at ghost_frac 0 and 0.5, its INT8-off twin in f32 with ghosts,
              and the zband path, each rank against the one-rank filter
              (int8 tolerance / 0.1 / 1e-5 / 0.05), 10 int8 gather launches a
              scan a rank, no overflow, p50 a rank; (14c) a dp-2 training
              step at config.yaml (bf16, one scan a rank) on two ranks on the
              card: parameters bit-equal across the ranks, finite losses,
              step ms and peak memory a rank.
  15. baselines trained, the workflow, NCLT - (15a, after phase 11 on the
              movers data) sps_torch/scripts/train_baselines.py's MOS4D,
              MapMOS and LTS trainers at the pipeline's sizes
              (config_loc_movers.yaml: 12288 points a scan, a 4-scan MOS4D
              buffer, 65536 map points) for a few steps each: finite
              losses, every parameter tensor moved, ms a step and peak
              memory; one step of each record of baseline_train_pin.npz on
              the card against the CPU's (f32 within 1e-4 of each leaf's
              max gradient, MOS4D in bf16 within its band) and the pin's
              loss; run_localization of mos4d, mapmos and lts from the new
              checkpoints on 20220629 (finite ATEs); (15b) the
              localization-evidence workflow at reduced depth:
              calibrate_threshold (val, 4 scans), loc_experiment (one run x
              20220629 x {sps, raw, sps@0.5} into summary.md),
              loc_calibrate_ate on {0.5, 0.99} with 15a's baselines
              (calibration.json, the sidecar's threshold, every table
              entry); (15c) check_nclt_headroom at config_nclt.yaml as
              shipped (110 m, ~6M map points, 12 scans; the filter at batch
              1 runs at the YAML's BRICKS halved, 14336 / 4096 / 1280 / 768
              / 512): no overflow, scores in (0, 1], the int8
              gather form's launches a scan by level, p50, kernel ms a
              scan, peak memory; the gather form at those brick counts bit
              for bit against its plain version, timed beside its bound,
              and the C = 192 split at L3 bit-equal to one launch.
  16. measurement tools - sps_torch/scripts/ at BLT scale: (16a)
              measure_occupancy at config.yaml as shipped over
              bench_world's 24 scans: each scan's occupied bricks / rows
              per level within that scan's quantization moves of sps_tpu's
              (sps_torch/assets/occupancy_pin.npz; a point that dividing by
              the voxel size and multiplying by its reciprocal put in
              different voxels moves a count by at most one), no overflow;
              (16b) measure_topo_reuse at the pin's depth (16 scans a step
              of 0.2 / 1.0 / 6.5 m, TOPO_EVERY 8): each scan's topology
              misses within quantization_bound of sps_tpu's
              (topo_reuse_pin.npz), the means and maxima beside
              exp_results/topo_reuse.json's; (16c) profile_stream at
              config.yaml as shipped, then with CONV_MODE zband, 8 scans
              each and the fused program: the stages' p50, kernel ms and
              launches, the top kernels; the stages' scores bit-equal to a
              StreamingFilter rebuild of the scan; brick_conv_int8_gather
              10 launches a UNet call (shipped), zband_conv on wgmma_k5 1
              and zband_conv_fused on wgmma 2 (zband), no other; (16d)
              measure_sp_scaling at sp = 2, one scan, all-gather and ghost
              (ghost_frac 0.5): collectives and bytes a scan, no ghost
              overflow, the ranks' scores equal, sps_tpu's HLO counts
              beside, and the analytic NCLT table.
  17. DIST_FEATURE + STEM_ZBAND - config.yaml as shipped with the
              distance feature (two input channels, DIST_CAP 1.0 as
              config_loc_movers_v2.yaml) and STEM_ZBAND, seeded full-width
              weights, phase 6's ten scans: one wgmma_k5_wide launch a scan
              at hz (11264, 12, 12, 48), 10 int8 gather launches a scan,
              no overflow, scores finite in (0, 1] and within 0.05 of the
              same filter with the halo stem; both filters' p50 and kernel
              ms a scan (profiler, 8 scans).
It then prints the card, one JSON line of per-kernel results and, last,
{"ok": true, "device": {...}}. With --profile it also traces 8 scans of
the zband path, 8 of the shipping path and 8 offline predict steps (9c)
with torch.profiler and prints the device busy share, the time per
profiler range and the top kernels.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# Dense H100 SXM peaks (NVIDIA data sheet): bf16 tensor cores, HBM3; TF32
# tensor cores (the wgmma_f32 route runs three TF32 products a multiply-add)
# and f32 outside the tensor cores (an FMA loop).
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
PEAK_TF32_FLOPS = 495e12
PEAK_F32_FLOPS = 67e12
REPLACES = {
    "zband_conv": "sps_tpu/ops/pallas_conv.py:218",
    "zband_conv_fused": "sps_tpu/ops/pallas_conv.py:310",
    # The f32 (BF16: false) calls of both at the shapes the wgmma_f32 route takes.
    "zband_conv_f32": "sps_tpu/ops/pallas_conv.py:218 and :310 (f32)",
    "microbench_zmm": "scripts/microbench_pallas.py::make_pallas_conv (_zmm_kernel :85-119)",
    # No Pallas source: the XLA int8 conv of sps_tpu/ops/brick.py::brick_conv_int8 (:703);
    # the gather form also takes in the halo assembly before it (:741).
    "brick_conv_int8": "sps_tpu/ops/brick.py:745",
    "brick_conv_int8_gather": "sps_tpu/ops/brick.py:745",
}
PEAK_INT8_OPS = 1979e12  # dense int8 tensor cores, H100 SXM

# The shipping path's int8 convs (config/config.yaml, batch 1): (call,
# level, calls a scan, TCin, TCout); B is the level's brick capacity.
INT8_CALLS = [
    ("block8_0.conv1", 0, 1, 32, 16), ("block8_0.conv2", 0, 1, 16, 16),
    ("block1_0.conv1/conv2", 1, 2, 16, 16), ("block7_0.conv1", 1, 1, 48, 32),
    ("block7_0.conv2", 1, 1, 32, 32), ("block2_0.conv1", 2, 1, 16, 32),
    ("block2_0.conv2", 2, 1, 32, 32), ("block6_0.conv1", 2, 1, 96, 64),
    ("block6_0.conv2", 2, 1, 64, 64),
]


def route_source(route) -> str:
    """The repo path of the source a route runs."""
    from sps_torch.ops import zband_conv as zc

    return os.path.relpath(zc.ROUTE_SOURCES[route], HERE)


_START = time.time()


def log(msg):
    """Print a line; a phase's first line also gets the seconds since the
    script started."""
    if msg.startswith("phase "):
        msg = f"{msg} [t+{time.time() - _START:.1f} s]"
    print(msg, flush=True)


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip().splitlines()[0]


def time_ms(fn, runs=20, warmup=3):
    """Median CUDA-event time of fn() over `runs` launches, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def make_case(k, bs, tcin, tcout, b, dtype, seed, with_res=True):
    """Seeded z-band operands: halo, band-packed weight and the fused
    epilogue's scale/bias/occ/res, in `dtype` (scale/bias f32)."""
    import torch

    from sps_torch.ops import brick as bk

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    h = bs + k - 1
    n = bs * tcout
    hz = torch.rand((b, h, h, h * tcin), generator=g, device=dev)
    w = torch.randn((k, k, k, tcin, tcout), generator=g, device=dev)
    wz = bk.pack_zband_kernel(w * (2.0 / (k**3 * tcin)) ** 0.5, bs, k // 2)
    scale = 0.5 + torch.rand(n, generator=g, device=dev)
    bias = 0.1 * torch.randn(n, generator=g, device=dev)
    occ = (torch.rand((b, bs, bs, n), generator=g, device=dev) < 0.5).float()
    res = torch.randn((b, bs, bs, n), generator=g, device=dev) * occ if with_res else None
    return dict(
        hz=hz.to(dtype), wz=wz.to(dtype), scale=scale, bias=bias, occ=occ.to(dtype),
        res=None if res is None else res.to(dtype), k=k, bs=bs,
    )


def make_general(b, c, n, seed):
    """Seeded stem-shaped operands (k = 5, bs = 8, h = 12) with any C and
    a random weight that is not band-packed, bf16."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    hz = torch.rand((b, 12, 12, c), generator=g, device="cuda")
    wz = torch.randn((5, 5, c, n), generator=g, device="cuda") * (2.0 / (25 * c)) ** 0.5
    return dict(hz=hz.bfloat16(), wz=wz.bfloat16(), k=5, bs=8)


def run_kernel(name, c, relu=True):
    from sps_torch.ops import zband_conv as zc

    if name == "zband_conv":
        return zc.zband_conv(c["hz"], c["wz"], c["k"], c["bs"])
    return zc.zband_conv_fused(c["hz"], c["wz"], c["scale"], c["bias"], c["occ"], c["res"],
                               k=c["k"], bs=c["bs"], relu=relu)


def run_wmma(name, c, relu=True):
    """The WMMA kernel (zband_conv.cu) on the same operands, through the
    op with its route given: the yardstick of the wgmma routes' calls."""
    import torch

    from sps_torch.ops import zband_conv as zc

    stream = torch.cuda.current_stream().cuda_stream
    op = getattr(torch.ops.sps_torch, name)
    if name == "zband_conv":
        return op(c["hz"], c["wz"], c["k"], c["bs"], zc.ROUTES["wmma"], stream)
    return op(c["hz"], c["wz"], c["scale"], c["bias"], c["occ"], c["res"], c["k"], c["bs"],
              relu, zc.ROUTES["wmma"], stream)


def routed(name, c, relu=True):
    """Run the kernel once; return (output, the route its launch took)."""
    from sps_torch.ops import zband_conv as zc

    before = dict(zc.ROUTE_LAUNCHES[name])
    out = run_kernel(name, c, relu)
    taken = [r for r, n in zc.ROUTE_LAUNCHES[name].items() if n != before[r]]
    if len(taken) != 1:
        raise AssertionError(f"{name}: one launch counted on routes {taken}")
    return out, taken[0]


def run_plain(name, c, relu=True):
    """The plain version on f32 copies of the same operands."""
    from sps_torch.ops import zband_conv as zc

    f = {key: (v.float() if hasattr(v, "float") else v) for key, v in c.items()}
    if name == "zband_conv":
        return zc.zband_conv_ref(f["hz"], f["wz"], f["k"], f["bs"])
    return zc.zband_conv_fused_ref(f["hz"], f["wz"], f["scale"], f["bias"], f["occ"],
                                   f["res"], k=f["k"], bs=f["bs"], relu=relu)


def check(name, c, relu, tag, route):
    """Kernel vs plain version on the expected route; returns the max abs error."""
    import torch

    got, taken = routed(name, c, relu)
    if taken != route:
        raise AssertionError(f"{name} {tag}: took route {taken}, expected {route}")
    want = run_plain(name, c, relu)
    torch.cuda.synchronize()
    err = (got.float() - want).abs()
    max_err = float(err.max())
    scale = float(want.abs().max())
    if c["hz"].dtype == torch.float32:
        ok = bool((err <= 1e-4 + 1e-4 * want.abs()).all())
        bar = "rtol 1e-4 / atol 1e-4"
    else:
        ok = max_err <= 2e-2 * max(scale, 1e-6)
        bar = "2e-2 x max-abs"
    log(f"  {name:17s} {tag:44s} {taken:5s} max_abs_err {max_err:.3e} "
        f"(out max-abs {scale:.3e}; {bar})")
    if not ok:
        raise AssertionError(f"{name} {tag}: kernel disagrees with its plain version")
    return max_err


def work(c, fused):
    """(FLOPs, bytes) of one call: the band's zeros included; every input
    read once, the output written once."""
    b, h, _, cin = c["hz"].shape
    k, bs = c["k"], c["bs"]
    n = c["wz"].shape[-1]
    m = b * bs * bs
    flops = 2 * m * k * k * cin * n
    item = c["hz"].element_size()
    nbytes = (c["hz"].numel() + c["wz"].numel() + m * n) * item
    if fused:
        nbytes += c["occ"].numel() * item + 2 * n * 4
        if c["res"] is not None:
            nbytes += c["res"].numel() * item
    return flops, nbytes


def phase_kernels(card):
    import torch
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("phase 2: kernels vs plain versions")
    small = [  # (k, bs, tcin, tcout, B, with_res, relu): tests/test_pallas_conv.py cases
        (3, 4, 2, 3, 8, True, True), (3, 8, 2, 2, 8, True, True), (5, 4, 1, 2, 8, True, True),
        (3, 4, 2, 2, 6, True, True), (3, 4, 2, 2, 4, True, True), (3, 4, 2, 2, 4, False, False),
    ]
    errs = {"zband_conv": 0.0, "zband_conv_fused": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for i, (k, bs, tcin, tcout, b, wres, relu) in enumerate(small):
            c = make_case(k, bs, tcin, tcout, b, dtype, seed=i, with_res=wres)
            tag = f"small k={k} bs={bs} tcin={tcin} tcout={tcout} B={b} {str(dtype)[6:]}"
            check("zband_conv", c, relu, tag, "wmma")
            check("zband_conv_fused", c, relu, tag + f" res={wres} relu={relu}", "wmma")
    # The wgmma route at ragged B (not a multiple of its 4 bricks per block),
    # both channel widths of L0 and one and two 128-column tiles, bf16.
    ragged = [  # (tcin, tcout, B, with_res, relu)
        (16, 16, 1, True, True), (32, 16, 3, False, True), (16, 32, 5, True, False),
        (32, 32, 3, True, True), (16, 16, 5, False, False), (32, 32, 1, False, True),
    ]
    for i, (tcin, tcout, b, wres, relu) in enumerate(ragged):
        c = make_case(3, 8, tcin, tcout, b, torch.bfloat16, seed=50 + i, with_res=wres)
        tag = f"ragged tcin={tcin} tcout={tcout} B={b} bfloat16"
        errs["zband_conv"] = max(errs["zband_conv"], check("zband_conv", c, relu, tag, "wgmma"))
        errs["zband_conv_fused"] = max(errs["zband_conv_fused"], check(
            "zband_conv_fused", c, relu, tag + f" res={wres} relu={relu}", "wgmma"))

    # The wgmma_k5 route at ragged B (not a multiple of its 4 bricks per
    # block): the stem's band-packed weight (C = 24) and random non-band
    # weights, which hold the general function, at every C its rule takes
    # and one and two 128-column tiles, bf16.
    stem_ragged = [  # (B, C, N, band-packed)
        (1, 24, 128, True), (3, 24, 256, True), (5, 24, 128, False),
        (3, 24, 256, False), (5, 16, 128, False), (1, 8, 128, False),
    ]
    for i, (b, cin, n, band) in enumerate(stem_ragged):
        c = (make_case(5, 8, cin // 12, n // 8, b, torch.bfloat16, seed=70 + i) if band
             else make_general(b, cin, n, seed=70 + i))
        tag = f"stem ragged B={b} C={cin} N={n} {'band' if band else 'random'} wz bfloat16"
        errs["zband_conv"] = max(errs["zband_conv"], check("zband_conv", c, True, tag,
                                                           "wgmma_k5"))

    # The wgmma_f32 route at ragged B (not a multiple of its 4 bricks per
    # block): k = 3 at both channel widths of L0, fused and not, one and two
    # 128-column tiles, and the k = 5 stem at C = 24 and the DIST_FEATURE
    # stem's C = 48 (band-packed and random weights).
    f32_ragged = [  # (k, tcin, tcout, B, fused, with_res)
        (3, 16, 16, 1, False, False), (3, 32, 16, 3, True, False), (3, 16, 32, 5, True, True),
        (3, 32, 32, 3, False, False), (5, 2, 16, 5, False, False), (5, 2, 32, 3, False, False),
        (5, 4, 16, 7, False, False), (5, 4, 32, 1, False, False),
    ]
    errs["zband_conv_f32"] = 0.0
    for i, (k, tcin, tcout, b, fused, wres) in enumerate(f32_ragged):
        c = make_case(k, 8, tcin, tcout, b, torch.float32, seed=60 + i, with_res=wres)
        name = "zband_conv_fused" if fused else "zband_conv"
        tag = f"ragged k={k} tcin={tcin} tcout={tcout} B={b} float32"
        errs["zband_conv_f32"] = max(errs["zband_conv_f32"], check(
            name, c, True, tag + (f" res={wres}" if fused else ""), "wgmma_f32"))
    for i, (b, cin, n) in enumerate([(5, 24, 128), (3, 16, 256), (7, 48, 128)]):
        g = make_general(b, cin, n, seed=80 + i)
        c = dict(g, hz=g["hz"].float(), wz=g["wz"].float())
        errs["zband_conv_f32"] = max(errs["zband_conv_f32"], check(
            "zband_conv", c, True, f"stem ragged B={b} C={cin} N={n} random wz float32",
            "wgmma_f32"))

    # The main path's L0 shapes at B = 11264 bricks (config.yaml, batch 1):
    # the k=5 stem, block8_0.conv1 (no residual) and conv2 (with residual).
    full = [
        ("zband_conv", "stem conv0p1s1", 5, 2, 16, False),
        ("zband_conv_fused", "block8_0.conv1", 3, 32, 16, False),
        ("zband_conv_fused", "block8_0.conv2", 3, 16, 16, True),
    ]
    per_call = []
    for i, (name, where, k, tcin, tcout, wres) in enumerate(full):
        route = "wgmma" if k == 3 else "wgmma_k5"
        c = make_case(k, 8, tcin, tcout, 11264, torch.bfloat16, seed=100 + i, with_res=wres)
        errs[name] = max(errs[name], check(name, c, True, f"full {where} hz"
                                           f"{tuple(c['hz'].shape)} bfloat16", route))
        x_nchw = c["hz"].permute(0, 3, 1, 2)
        w_oihw = c["wz"].permute(3, 2, 0, 1)
        ms = time_ms(lambda: run_kernel(name, c))
        wmma_ms = time_ms(lambda: run_wmma(name, c)) if route != "wmma" else ms
        plain_ms = time_ms(lambda: run_plain(name, c))
        library_ms = time_ms(lambda: F.conv2d(x_nchw, w_oihw))
        flops, nbytes = work(c, name == "zband_conv_fused")
        bound_ms = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
        bound_by = "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_HBM_BYTES else "bytes"
        per_call.append(dict(name=name, call=where, route=route, source=route_source(route),
                             ms=ms, wmma_ms=wmma_ms,
                             plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                             bound_by=bound_by, gflop=flops / 1e9, gbytes=nbytes / 1e9))
        log(f"  time {name:17s} {where:15s} bf16 [{card}]: kernel ({route}) {ms:.3f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s), wmma kernel {wmma_ms:.3f} ms "
            f"({wmma_ms / ms:.2f}x), plain {plain_ms:.3f} ms, F.conv2d {library_ms:.3f} ms, "
            f"bound {bound_ms:.3f} ms ({bound_by}; {flops / 1e9:.1f} GFLOP, "
            f"{nbytes / 1e9:.3f} GB)")
        del c, x_nchw, w_oihw
        torch.cuda.empty_cache()
    # K3's shape (k = 3, TC 16, unfused) beside the WMMA kernel in this call.
    c = make_case(3, 8, 16, 16, 11264, torch.bfloat16, seed=110, with_res=False)
    k3 = dict(ms=time_ms(lambda: run_kernel("zband_conv", c)),
              wmma_ms=time_ms(lambda: run_wmma("zband_conv", c)))
    log(f"  time zband_conv       K3 shape        bf16 [{card}]: kernel (wgmma) "
        f"{k3['ms']:.3f} ms, wmma kernel {k3['wmma_ms']:.3f} ms "
        f"({k3['wmma_ms'] / k3['ms']:.2f}x)")
    del c
    torch.cuda.empty_cache()
    per_call_f32 = [phase_f32_call(card, errs, name, where, k, tcin, wres, seed)
                    for name, where, k, tcin, wres, seed in (
                        ("zband_conv", "stem conv0p1s1", 5, 2, False, 100),
                        ("zband_conv_fused", "block8_0.conv1", 3, 32, False, 101),
                        ("zband_conv_fused", "block8_0.conv2", 3, 16, True, 102),
                        ("zband_conv", "K3", 3, 16, False, 110))]
    return errs, per_call, k3, per_call_f32, phase_dist_stem(card, errs)


def phase_f32_call(card, errs, name, where, k, tcin, wres, seed):
    """One f32 call at its full shape (B = 11264, TCout 16) on the
    wgmma_f32 route: held against its plain version (rtol / atol 1e-4),
    then the kernel, the WMMA kernel on the same operands, the plain
    version and F.conv2d in f32 (TF32 off) timed beside the 3xTF32 bound
    (three TF32 products a multiply-add at the TF32 peak, or the bytes), the
    FMA-only bound (the band's FLOPs at the f32 peak) and the bytes."""
    import torch
    import torch.nn.functional as F

    c = make_case(k, 8, tcin, 16, 11264, torch.float32, seed=seed, with_res=wres)
    e = check(name, c, True, f"full {where} hz{tuple(c['hz'].shape)} float32", "wgmma_f32")
    errs["zband_conv_f32"] = max(errs["zband_conv_f32"], e)
    x_nchw, w_oihw = c["hz"].permute(0, 3, 1, 2), c["wz"].permute(3, 2, 0, 1)
    ms = time_ms(lambda: run_kernel(name, c))
    wmma_ms = time_ms(lambda: run_wmma(name, c))
    plain_ms = time_ms(lambda: run_plain(name, c))
    library_ms = time_ms(lambda: F.conv2d(x_nchw, w_oihw))
    flops, nbytes = work(c, name == "zband_conv_fused")
    t_ops, t_bytes = 3 * flops / PEAK_TF32_FLOPS, nbytes / PEAK_HBM_BYTES
    bound_ms, fma_ms = max(t_ops, t_bytes) * 1e3, flops / PEAK_F32_FLOPS * 1e3
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    log(f"  time {name:17s} {where:15s} f32 [{card}]: kernel (wgmma_f32) {ms:.3f} ms "
        f"({flops / ms / 1e9:.1f} TFLOP/s of band), wmma kernel {wmma_ms:.3f} ms "
        f"({wmma_ms / ms:.2f}x), plain {plain_ms:.3f} ms, F.conv2d f32 {library_ms:.3f} ms "
        f"({library_ms / ms:.2f}x), 3xTF32 bound {bound_ms:.3f} ms ({bound_by}), FMA-only "
        f"bound {fma_ms:.3f} ms, bytes {t_bytes * 1e3:.3f} ms ({flops / 1e9:.1f} GFLOP, "
        f"{nbytes / 1e9:.3f} GB)")
    del c, x_nchw, w_oihw
    torch.cuda.empty_cache()
    return dict(name=name, call=where, route="wgmma_f32", source=route_source("wgmma_f32"),
                ms=ms, wmma_ms=wmma_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, bound_fma_ms=fma_ms,
                bound_bytes_ms=t_bytes * 1e3, gflop=flops / 1e9, gbytes=nbytes / 1e9,
                max_abs_err=e)


def phase_dist_stem(card, errs):
    """The C = 48 stem of DIST_FEATURE (k = 5, TCin 4) on its wgmma route
    ("wgmma_k5_wide"): held against its plain version at ragged B (band-packed
    and random weights, one and two column tiles) and at full
    shape, timed beside the WMMA kernel on the same operands, its bound, the
    floor of the work it executes (the k-steps of wz that are not all zero),
    the plain version and F.conv2d; then the same call in f32 on
    the wgmma_f32 route (phase_f32_call)."""
    import torch
    import torch.nn.functional as F

    wide = [  # (B, C, N, band-packed)
        (1, 48, 128, True), (7, 48, 128, False), (11263, 48, 128, True), (3, 48, 256, False),
        (5, 48, 128, True), (1, 48, 256, True),
    ]
    err = 0.0
    for i, (b, cin, n, band) in enumerate(wide):
        c = (make_case(5, 8, cin // 12, n // 8, b, torch.bfloat16, seed=130 + i) if band
             else make_general(b, cin, n, seed=130 + i))
        tag = f"DIST stem ragged B={b} C={cin} N={n} {'band' if band else 'random'} wz bfloat16"
        err = max(err, check("zband_conv", c, True, tag, "wgmma_k5_wide"))
        del c
    c = make_case(5, 8, 4, 16, 11264, torch.bfloat16, seed=120, with_res=False)
    err = max(err, check("zband_conv", c, True,
                         f"full DIST_FEATURE stem hz{tuple(c['hz'].shape)} bfloat16",
                         "wgmma_k5_wide"))
    x_nchw, w_oihw = c["hz"].permute(0, 3, 1, 2), c["wz"].permute(3, 2, 0, 1)
    ms = time_ms(lambda: run_kernel("zband_conv", c))
    wmma_ms = time_ms(lambda: run_wmma("zband_conv", c))
    plain_ms = time_ms(lambda: run_plain("zband_conv", c))
    library_ms = time_ms(lambda: F.conv2d(x_nchw, w_oihw))
    flops, nbytes = work(c, False)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    bound_ms, bound_by = max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"
    # The kernel multiplies the k-steps of each 64-column tile whose weight
    # holds a value other than 0 at some tap: their FLOPs at the bf16 peak.
    wzb = c["wz"].reshape(25, 3, 16, -1, 64)
    done = float(wzb.ne(0).any(dim=4).any(dim=2).any(dim=0).float().mean())
    floor_ms = done * t_ops * 1e3
    log(f"  time zband_conv       DIST stem C=48  bf16 [{card}]: kernel (wgmma_k5_wide) "
        f"{ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s of band), wmma kernel {wmma_ms:.3f} ms "
        f"({wmma_ms / ms:.2f}x), plain {plain_ms:.3f} ms, F.conv2d {library_ms:.3f} ms "
        f"({library_ms / ms:.2f}x), bound {bound_ms:.3f} ms ({bound_by}; {flops / 1e9:.1f} "
        f"GFLOP, {nbytes / 1e9:.3f} GB), executed-work floor {floor_ms:.3f} ms "
        f"({100 * done:.1f}% of the k-steps)")
    del c, x_nchw, w_oihw
    torch.cuda.empty_cache()
    f32 = phase_f32_call(card, errs, "zband_conv", "DIST stem C=48", 5, 4, False, 121)
    return dict(call="DIST_FEATURE stem", route="wgmma_k5_wide",
                source=route_source("wgmma_k5_wide"), ms=ms, wmma_ms=wmma_ms,
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                executed_floor_ms=floor_ms, executed_share=done, gflop=flops / 1e9,
                gbytes=nbytes / 1e9, max_abs_err=err, f32=f32)


def int8_case(b, c, n, seed, kind="rand"):
    """Seeded int8 operands: halo codes and the weight in the quantizer's
    layout (a transposed view of (3, 3, 3, N, C)), and an f32 scale. kind
    "rand": random codes; "zero": a zero halo; "max": every code +-127,
    the halo's sign set per channel (sigma_c) and the weight's to
    sigma_c * tau_n, so that |acc| = 27 * C * 127**2 everywhere; "pm127":
    as "max" with 5% of the weight's signs flipped, which leaves |acc| above
    2**24, where int32 -> f32 rounds."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def signs(shape):
        return torch.randint(0, 2, shape, generator=g, device="cuda") * 2 - 1

    if kind in ("max", "pm127"):
        sigma, tau = signs((c,)), signs((n, 1))
        h8 = (127 * sigma).expand(b, 10, 10, 10, c)
        w8 = (127 * sigma * tau).expand(3, 3, 3, n, c)
        if kind == "pm127":
            flip = torch.rand((3, 3, 3, n, c), generator=g, device="cuda") < 0.05
            w8 = torch.where(flip, -w8, w8)
    else:
        h8 = torch.randint(-127, 128, (b, 10, 10, 10, c), generator=g, device="cuda")
        w8 = torch.randint(-127, 128, (3, 3, 3, n, c), generator=g, device="cuda")
        if kind == "zero":
            h8 = torch.zeros_like(h8)
    scale = (0.5 + torch.rand(n, generator=g, device="cuda")) * 1e-4
    return (h8.to(torch.int8).contiguous(), w8.to(torch.int8).contiguous().transpose(-1, -2),
            scale)


def check_int8(h8, w8, scale, tag):
    """The kernel against its plain version, bit for bit, bf16 and f32 out."""
    import torch

    from sps_torch.ops import brick_conv_int8 as bi8

    for dtype, bits in ((torch.bfloat16, torch.int16), (torch.float32, torch.int32)):
        got = bi8.brick_conv_int8(h8, w8, scale, dtype)
        want = bi8.brick_conv_int8_ref(h8, w8, scale, dtype)
        torch.cuda.synchronize()
        same = torch.equal(got.view(bits), want.view(bits))
        err = float((got.float() - want.float()).abs().max())
        log(f"  brick_conv_int8 {tag:44s} {str(dtype)[6:]:8s} bit-equal {same} "
            f"(max_abs_err {err:.3e}, out max-abs {float(want.float().abs().max()):.3e})")
        if not same:
            raise AssertionError(f"brick_conv_int8 {tag} {dtype}: kernel differs from plain")


def phase_int8_kernel(card, bricks):
    """Phase 2, second part: brick_conv_int8.cu against its plain version.
    Returns the per-shape records (ms a call, calls a scan)."""
    import torch
    import torch.nn.functional as F

    from sps_torch.ops import brick_conv_int8 as bi8

    log("phase 2b: int8 brick conv vs its plain version, bit for bit")
    for i, (b, c, n, kind) in enumerate([(1, 16, 16, "rand"), (3, 48, 32, "rand"),
                                         (5, 96, 64, "rand"), (3, 32, 16, "zero"),
                                         (3, 96, 64, "max"), (5, 64, 64, "pm127"),
                                         (1, 96, 32, "pm127")]):
        check_int8(*int8_case(b, c, n, seed=200 + i, kind=kind),
                   f"ragged B={b} C={c} N={n} {kind}")
    for c, n in ((24, 16), (32, 8)):
        h8, w8, scale = int8_case(2, c, n, seed=0)
        for name, fn in (("wrapper", lambda: bi8.brick_conv_int8(h8, w8, scale, torch.bfloat16)),
                         ("op", lambda: torch.ops.sps_torch.brick_conv_int8(
                             h8, w8.transpose(-1, -2).contiguous(), scale, True,
                             torch.cuda.current_stream().cuda_stream))):
            try:
                fn()
            except (ValueError, RuntimeError) as e:
                log(f"  unsupported C={c} N={n}: the {name} raises ({str(e).splitlines()[0][:70]})")
            else:
                raise AssertionError(f"brick_conv_int8 took C={c} N={n} through its {name}")
    calls = []
    for i, (where, level, per_scan, c, n) in enumerate(INT8_CALLS):
        b = bricks[level]
        h8, w8, scale = int8_case(b, c, n, seed=300 + i)
        check_int8(h8, w8, scale, f"full {where} h8{tuple(h8.shape)} N={n}")
        ms = time_ms(lambda: bi8.brick_conv_int8(h8, w8, scale, torch.bfloat16))
        plain_ms = time_ms(lambda: bi8.brick_conv_int8_ref(h8, w8, scale, torch.bfloat16),
                           runs=5, warmup=1)
        hb = h8.to(torch.bfloat16).permute(0, 4, 1, 2, 3)
        wb = w8.to(torch.bfloat16).permute(4, 3, 0, 1, 2)
        conv3d_ms = time_ms(lambda: F.conv3d(hb, wb))
        ops = 2 * b * 512 * 27 * c * n
        nbytes = h8.numel() + w8.numel() + 4 * n + b * 512 * n * 2
        bound_ms = max(ops / PEAK_INT8_OPS, nbytes / PEAK_HBM_BYTES) * 1e3
        bound_by = "operations" if ops / PEAK_INT8_OPS >= nbytes / PEAK_HBM_BYTES else "bytes"
        calls.append(dict(call=where, level=f"L{level}", calls_per_scan=per_scan, b=b, c=c, n=n,
                          ms=ms, plain_ms=plain_ms, conv3d_bf16_ms=conv3d_ms,
                          bound_ms=bound_ms, bound_by=bound_by, gop=ops / 1e9,
                          gbytes=nbytes / 1e9))
        log(f"  time brick_conv_int8 {where:20s} L{level} B={b} {c}->{n} bf16 [{card}]: "
            f"kernel {ms:.3f} ms ({ops / ms / 1e9:.1f} TOP/s), plain {plain_ms:.3f} ms, "
            f"bf16 F.conv3d {conv3d_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}; "
            f"{ops / 1e9:.1f} GOP, {nbytes / 1e9:.3f} GB)")
        del h8, w8, scale, hb, wb
        torch.cuda.empty_cache()
    per_scan = {k: sum(c[k] * c["calls_per_scan"] for c in calls)
                for k in ("ms", "plain_ms", "conv3d_bf16_ms", "bound_ms")}
    log(f"  brick_conv_int8 per scan (10 calls) [{card}]: kernel {per_scan['ms']:.3f} ms, "
        f"bound {per_scan['bound_ms']:.3f} ms, plain {per_scan['plain_ms']:.3f} ms, "
        f"bf16 F.conv3d {per_scan['conv3d_bf16_ms']:.3f} ms")
    return calls


def gather_case(b, num_bricks, c, n, seed, kind="rand"):
    """Seeded operands of the gather form: codes (b, 8, 8, 8, C) (zero past
    num_bricks, as the masked features are), a grid_table, and the weight
    and scale of int8_case. kind "allabsent": every neighbour row -1 but
    the centre; "pm127": int8_case's +-127 codes and 5%-flipped signs."""
    import torch

    from sps_torch.scripts.int8_variants import grid_table

    rng = np.random.default_rng(seed)
    nbr = grid_table(b, num_bricks, rng)
    if kind == "allabsent":
        nbr[np.arange(27) != 13] = -1
    h8, w8, scale = int8_case(b, c, n, seed, "pm127" if kind == "pm127" else "rand")
    q8 = h8[:, :8, :8, :8].contiguous()
    q8[num_bricks:] = 0
    return q8, torch.from_numpy(nbr).cuda(), w8, scale


def check_gather(q8, nbr, w8, scale, tag):
    """The gather form against its plain version, bit for bit, bf16 and f32."""
    import torch

    from sps_torch.ops import brick_conv_int8 as bi8

    for dtype, bits in ((torch.bfloat16, torch.int16), (torch.float32, torch.int32)):
        got = bi8.brick_conv_int8_gather(q8, nbr, w8, scale, dtype)
        want = bi8.brick_conv_int8_gather_ref(q8, nbr, w8, scale, dtype)
        torch.cuda.synchronize()
        same = torch.equal(got.view(bits), want.view(bits))
        err = float((got.float() - want.float()).abs().max())
        log(f"  brick_conv_int8_gather {tag:48s} {str(dtype)[6:]:8s} bit-equal {same} "
            f"(max_abs_err {err:.3e}, out max-abs {float(want.float().abs().max()):.3e})")
        if not same:
            raise AssertionError(f"brick_conv_int8_gather {tag} {dtype}: kernel differs from plain")


def phase_int8_gather(card, bricks):
    """Phase 2b, third part: the gather form of brick_conv_int8.cu against
    its plain version, and its time beside the halo form's on the same
    codes and table. Returns the per-shape records."""
    import torch
    import torch.nn.functional as F

    from sps_torch.ops import brick as bk
    from sps_torch.ops import brick_conv_int8 as bi8
    from sps_torch.scripts.int8_variants import gather_bound

    log("phase 2b: int8 brick conv, gather form, vs its plain version, bit for bit")
    # The last three: B not a multiple of any grid (132 x blocks an SM), B
    # smaller than the grid, and every slot of a large B empty.
    for i, (b, nb, c, n, kind) in enumerate([
            (1, 1, 16, 16, "rand"), (3, 2, 48, 32, "rand"), (5, 4, 96, 64, "rand"),
            (5, 5, 32, 16, "allabsent"), (3, 0, 32, 32, "rand"), (5, 4, 96, 64, "pm127"),
            (3, 3, 64, 64, "pm127"), (1001, 900, 32, 16, "rand"), (100, 90, 96, 64, "rand"),
            (600, 0, 16, 32, "rand")]):
        check_gather(*gather_case(b, nb, c, n, seed=400 + i, kind=kind),
                     f"ragged B={b} num_bricks={nb} C={c} N={n} {kind}")
    q8, nbr, w8, scale = gather_case(4, 3, 32, 16, seed=0)
    stream = torch.cuda.current_stream().cuda_stream
    refused = [
        ("C=24", dict(q8=torch.zeros((4, 8, 8, 8, 24), dtype=torch.int8, device="cuda"),
                      w8=torch.zeros((3, 3, 3, 24, 16), dtype=torch.int8, device="cuda"))),
        ("N=8", dict(w8=torch.zeros((3, 3, 3, 32, 8), dtype=torch.int8, device="cuda"),
                     scale=scale[:8])),
        ("int64 nbr27", dict(nbr=nbr.long())),
        ("nbr27 (26, B)", dict(nbr=nbr[:26].contiguous())),
        ("bs=4 q8", dict(q8=torch.zeros((4, 4, 4, 4, 32), dtype=torch.int8, device="cuda"))),
    ]
    for what, over in refused:
        a = {**dict(q8=q8, nbr=nbr, w8=w8, scale=scale), **over}
        for name, fn in (("wrapper", lambda: bi8.brick_conv_int8_gather(
                              a["q8"], a["nbr"], a["w8"], a["scale"], torch.bfloat16)),
                         ("op", lambda: torch.ops.sps_torch.brick_conv_int8_gather(
                             a["q8"], a["nbr"], a["w8"].transpose(-1, -2).contiguous(),
                             a["scale"], True, stream))):
            try:
                fn()
            except (ValueError, RuntimeError) as e:
                log(f"  unsupported {what}: the {name} raises ({str(e).splitlines()[0][:70]})")
            else:
                raise AssertionError(f"brick_conv_int8_gather took {what} through its {name}")
    calls = []
    for i, (where, level, per_scan, c, n) in enumerate(INT8_CALLS):
        b = bricks[level]
        nb = b - b // 10
        q8, nbr, w8, scale = gather_case(b, nb, c, n, seed=500 + i)
        absent = float((nbr[:, :nb] < 0).float().mean())
        check_gather(q8, nbr, w8, scale, f"full {where} q8{tuple(q8.shape)} N={n}")
        h8 = bk.halo(q8, nbr, 1)
        qb = q8.to(torch.bfloat16)
        wb = w8.to(torch.bfloat16).permute(4, 3, 0, 1, 2)
        ms = time_ms(lambda: bi8.brick_conv_int8_gather(q8, nbr, w8, scale, torch.bfloat16))
        halo_ms = time_ms(lambda: bi8.brick_conv_int8(bk.halo(q8, nbr, 1), w8, scale,
                                                      torch.bfloat16))
        halo_form_ms = time_ms(lambda: bi8.brick_conv_int8(h8, w8, scale, torch.bfloat16))
        conv3d_ms = time_ms(lambda: F.conv3d(bk.halo(qb, nbr, 1).permute(0, 4, 1, 2, 3), wb))
        plain_ms = time_ms(lambda: bi8.brick_conv_int8_gather_ref(q8, nbr, w8, scale,
                                                                  torch.bfloat16),
                           runs=5, warmup=1)
        ops, nbytes, bound_ms, bound_by = gather_bound(b, nb, c, n)
        calls.append(dict(call=where, level=f"L{level}", calls_per_scan=per_scan, b=b,
                          num_bricks=nb, absent=absent, c=c, n=n, ms=ms, plain_ms=plain_ms,
                          halo_plus_halo_form_ms=halo_ms, halo_form_ms=halo_form_ms,
                          halo_conv3d_bf16_ms=conv3d_ms, bound_ms=bound_ms, bound_by=bound_by,
                          gop=ops / 1e9, gbytes=nbytes / 1e9))
        log(f"  time brick_conv_int8_gather {where:20s} L{level} B={b} ({nb} bricks, "
            f"{100 * absent:.0f}% absent) {c}->{n} bf16 [{card}]: gather {ms:.3f} ms "
            f"({ops / ms / 1e9:.1f} TOP/s), halo()+halo form {halo_ms:.3f} ms, halo form "
            f"alone {halo_form_ms:.3f} ms, bf16 halo()+F.conv3d {conv3d_ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}; {ops / 1e9:.1f} GOP, "
            f"{nbytes / 1e9:.3f} GB)")
        del q8, nbr, w8, scale, h8, qb, wb
        torch.cuda.empty_cache()
    per_scan = {k: sum(c[k] * c["calls_per_scan"] for c in calls)
                for k in ("ms", "halo_plus_halo_form_ms", "halo_form_ms", "halo_conv3d_bf16_ms",
                          "plain_ms", "bound_ms")}
    log(f"  brick_conv_int8_gather per scan (10 calls) [{card}]: gather {per_scan['ms']:.3f} ms, "
        f"bound {per_scan['bound_ms']:.3f} ms, halo()+halo form "
        f"{per_scan['halo_plus_halo_form_ms']:.3f} ms, halo form alone "
        f"{per_scan['halo_form_ms']:.3f} ms, bf16 halo()+F.conv3d "
        f"{per_scan['halo_conv3d_bf16_ms']:.3f} ms")
    return calls


def blt_scale_scans(n_scans, ns, traj_step=0.2, extent=50.0):
    """BLT-scale synthetic world (~1.2M-point map) and n_scans scans taken
    traj_step metres apart along a loop, padded to ns points: the
    benchmark's world (sps_torch.data.bench_world)."""
    from sps_torch.data import bench_world

    return bench_world.make_data(ns, n_scans, extent=extent, traj_step=traj_step)


def phase_parity():
    """The filter on the card vs on the CPU: same small world, weights, scans;
    the zband configuration, then the shipping options."""
    import torch

    from sps_torch import config
    from sps_torch.data import synthetic
    from sps_torch.models import spsnet
    from sps_torch.stream.engine import StreamingFilter

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("phase 3: streaming filter, card vs CPU (f32, config_small, full width)")
    base = config.load(os.path.join(HERE, "config", "config_small.yaml"))
    for label, opts in (("zband", dict(conv_mode="zband", zband_levels=1, int8=False)),
                        ("shipping int8-off", dict(conv_mode="halo", int8=False, head_fold=True)),
                        ("shipping", dict(conv_mode="halo", int8=True, head_fold=True))):
        cfg = dataclasses.replace(base, tpu=dataclasses.replace(
            base.tpu, engine="atlas", bf16=False, topo_every=2, **opts))
        sd = spsnet.init_state_dict(cfg.sps_config(1), seed=1)
        stable = synthetic.make_world(seed=3, extent=10.0, n_stable=10, ground_points=6000)
        rng = np.random.default_rng(3)
        clutter = synthetic._boxes(rng, 3, 8.0).astype(np.float32)
        f_gpu = StreamingFilter(cfg, sd, stable)
        f_cpu = StreamingFilter(cfg, sd, stable, device="cpu")
        ns = cfg.tpu.scan_points
        for i in range(2):  # rebuild, then reuse
            pts, lab = synthetic.sample_scan(rng, stable, clutter, np.array([0.2 * i, 0.0]),
                                             n_rays=400)
            x = np.zeros((ns, 3), np.float32)
            v = np.zeros(ns, bool)
            lb = np.zeros(ns, np.float32)
            k = min(len(pts), ns)
            x[:k], v[:k], lb[:k] = pts[:k], True, lab[:k]
            pose = np.eye(4, dtype=np.float32)
            s_g, _, st_g = f_gpu(x, v, lb, pose)
            s_c, _, st_c = f_cpu(x, v, lb, pose)
            s_g = s_g.cpu()
            diff = (s_g - s_c).abs()
            log(f"  {label} scan {i}: max |score_card - score_cpu| {float(diff.max()):.3e} "
                f"({int((diff > 1e-6).sum())} of {int(v.sum())} valid points beyond 1e-6), "
                f"n_scan_voxels {int(st_g['n_scan_voxels'])}/{int(st_c['n_scan_voxels'])}, "
                f"overflow {bool(st_g['overflow'])}")
            if opts["int8"]:
                check_int8_parity(s_g.numpy(), s_c.numpy(), v, cfg.threshold)
            else:
                torch.testing.assert_close(s_g, s_c, rtol=1e-3, atol=1e-4)
            for key in ("n_scan_voxels", "n_submap_voxels", "topo_miss_points", "overflow"):
                if int(st_g[key]) != int(st_c[key]):
                    raise AssertionError(f"parity {label} scan {i}: {key} differs")
        del f_gpu, f_cpu
        torch.cuda.empty_cache()


INT8_ATOL = 2e-3


def check_int8_parity(got, want, valid, eps):
    """The int8 path on two devices. The codes round(x / s_in) move by one
    where an input lies at a rounding tie and the devices' f32 sums differ
    in their last bits (a diagnostic run found 2 of 25M codes at the first
    such conv, both within 1.1e-5 of the tie); the difference then
    propagates. One code step is 1/127 of a layer's max-abs, and through
    the sigmoid (slope <= 1/4) it moves a score by at most ~2e-3: every
    score within INT8_ATOL, keep decisions equal beyond 1e-2 of eps (the
    tolerance of tests/test_torch_halo.py)."""
    err = float(np.abs(got - want).max())
    if not err <= INT8_ATOL:
        raise AssertionError(f"int8 parity: max |dscore| {err} exceeds {INT8_ATOL}")
    far = valid & (np.abs(want - eps) > 1e-2)
    if ((got <= eps) != (want <= eps))[far].any():
        raise AssertionError("int8 parity: a keep decision flips beyond 1e-2 of eps")


def routes(**counts):
    """Launches per z-band route: `counts` where given, 0 on the others."""
    from sps_torch.ops import zband_conv as zc

    return {r: counts.get(r, 0) for r in zc.ROUTES}


def reset_counts():
    """Set every kernel's launch count to 0."""
    from sps_torch.ops import brick_conv_int8 as bi8
    from sps_torch.ops import zband_conv as zc

    zc.reset_launches()
    bi8.reset_launches()


def read_counts():
    """Every kernel's launch count: the z-band kernels per route, then the
    int8 kernel's halo and gather forms."""
    from sps_torch.ops import brick_conv_int8 as bi8
    from sps_torch.ops import zband_conv as zc

    return {**{name: dict(r) for name, r in zc.ROUTE_LAUNCHES.items()}, **bi8.LAUNCHES,
            **bi8.GATHER_LAUNCHES}


def drive(cfg, sd, stable, data):
    """The filter over the scans with every launch count set to 0 just
    before and read just after. Returns the filter and the run: per-scan
    latencies, scores/keep as numpy, stats as numbers, launches (and the
    z-band kernels' launches per shape), peak device memory."""
    import torch

    from sps_torch.ops import zband_conv as zc
    from sps_torch.stream.engine import StreamingFilter

    scans, valids, labels = data
    filt = StreamingFilter(cfg, sd, stable)
    pose = np.eye(4, dtype=np.float32)  # scans are already in the map frame
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    lat, results = [], []
    for i in range(len(scans)):
        torch.cuda.synchronize()
        t = time.perf_counter()
        results.append(filt(scans[i], valids[i], labels[i], pose))
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
    launches = read_counts()
    shape_launches = dict(zc.SHAPE_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    scores = [r[0].float().cpu().numpy() for r in results]
    keep = [r[1].cpu().numpy() for r in results]
    stats = [{k: float(v) for k, v in r[2].items()} for r in results]
    return filt, dict(lat=lat, scores=scores, keep=keep, stats=stats, launches=launches,
                      shape_launches=shape_launches, peak=peak)


def check_run(run, valids, topo_every, card, label):
    """Phase 4's checks on a run; prints each scan and the latencies."""
    for i, (s, st) in enumerate(zip(run["scores"], run["stats"])):
        v = valids[i]
        prog = "rebuild" if i % topo_every == 0 else "reuse"
        log(f"  scan {i} ({prog}): {run['lat'][i]:.2f} ms, n_kept {int(st['n_kept'])}, "
            f"n_scan_voxels {int(st['n_scan_voxels'])}, n_submap_voxels "
            f"{int(st['n_submap_voxels'])}, topo_miss_points "
            f"{int(st['topo_miss_points'])}, dIoU {st['dIoU']:.4f}, "
            f"overflow {bool(st['overflow'])}")
        if bool(st["overflow"]):
            raise AssertionError(f"{label} scan {i}: capacity overflow")
        if s.shape != v.shape or not np.isfinite(s).all():
            raise AssertionError(f"{label} scan {i}: scores not finite / wrong shape {s.shape}")
        if s.min() < 0 or s.max() > 1 or (s[~v] != 0).any() or not (s[v] > 0).all():
            raise AssertionError(f"{label} scan {i}: scores outside (0, 1] on valid points")
        if int(st["n_kept"]) <= 0:
            raise AssertionError(f"{label} scan {i}: no point kept")
        if "topo_miss_points" not in st:
            raise AssertionError(f"{label} scan {i}: topo_miss_points not reported")
    p50 = statistics.median(run["lat"])
    log(f"  {label}: per-scan latency ms {[round(x, 2) for x in run['lat']]}; p50 {p50:.2f} ms; "
        f"peak device memory {run['peak'] / 2**30:.2f} GiB [{card}]")
    return p50


def check_launches(run, want, label):
    log(f"  {label}: kernel launches {run['launches']} (expected {want})")
    if run["launches"] != want:
        raise AssertionError(f"{label}: launches {run['launches']}, expected {want}")


def compare_runs(a, b, valids, eps, bound, what):
    """max |dscore| over valid points and keep flips at eps of run a
    against run b; raises beyond the bound."""
    d = max(float(np.abs(sa - sb)[v].max()) for sa, sb, v in zip(a["scores"], b["scores"], valids))
    flips = sum(int(((sa <= eps) != (sb <= eps))[v].sum())
                for sa, sb, v in zip(a["scores"], b["scores"], valids))
    n = sum(int(v.sum()) for v in valids)
    log(f"  {what}: max |dscore| {d:.4e} (bound {bound}), keep flips at eps {eps}: {flips} "
        f"of {n} valid points")
    if not d <= bound:
        raise AssertionError(f"{what}: max |dscore| {d} exceeds {bound}")
    return dict(max_dscore=d, keep_flips=flips, valid_points=n)


def twin(cfg, **tpu):
    return dataclasses.replace(cfg, tpu=dataclasses.replace(cfg.tpu, **tpu))


def phase_path(card, shipped, sd, stable, data, profile):
    import torch

    log("phase 4: zband path (config.yaml, zband, int8 off, bf16, full width)")
    cfg = twin(shipped, conv_mode="zband", zband_levels=1, int8=False)
    scfg = cfg.sps_config(1)
    log(f"  caps {scfg.caps.bricks} extent {scfg.atlas_extent} planes {scfg.unet.planes} "
        f"dtype {scfg.unet.dtype} topo_every {cfg.tpu.topo_every}")
    filt, run = drive(cfg, sd, stable, data)
    log(f"  map atlas: {int(filt.map_grid.num_bricks)} bricks, extent {filt.map_grid.extent}")
    n_scans = len(data[0])
    run["p50"] = check_run(run, data[1], cfg.tpu.topo_every, card, "zband path")
    check_launches(run, {"zband_conv": routes(wgmma_k5=n_scans),
                         "zband_conv_fused": routes(wgmma=2 * n_scans),
                         "brick_conv_int8": 0, "brick_conv_int8_gather": 0}, "zband path")
    if profile:
        phase_profile(filt, data, card, "zband path")
    del filt
    torch.cuda.empty_cache()
    _, f32 = drive(twin(cfg, bf16=False), sd, stable, data)
    # In f32 the stem and both block8 convs take the 3xTF32 wgmma kernel.
    check_launches(f32, {"zband_conv": routes(wgmma_f32=n_scans),
                         "zband_conv_fused": routes(wgmma_f32=2 * n_scans),
                         "brick_conv_int8": 0, "brick_conv_int8_gather": 0}, "zband path f32")
    run["f32_launches"] = f32["launches"]
    run["bf16_vs_f32"] = compare_runs(run, f32, data[1], cfg.threshold, 0.05,
                                      "zband path bf16 vs f32")
    return run


def count_halo_calls(fn):
    """fn()'s result and the number of ops/brick.halo calls it made."""
    from sps_torch.ops import brick as bk

    real, n = bk.halo, [0]

    def counted(*args, **kwargs):
        n[0] += 1
        return real(*args, **kwargs)

    bk.halo = counted
    try:
        return fn(), n[0]
    finally:
        bk.halo = real


def int8_path_bound(num_bricks, caps):
    """gather_bound summed over a scan's ten int8 calls at the levels'
    brick counts (B = the capacities)."""
    from sps_torch.scripts.int8_variants import gather_bound

    return sum(gather_bound(caps[level], num_bricks[level], c, n)[2] * per_scan
               for _, level, per_scan, c, n in INT8_CALLS)


def phase_shipping(card, shipped, sd, stable, data, profile):
    """The shipping path: config/config.yaml as shipped, then its int8-off
    twin and that twin in f32, over the same scans and weights."""
    import torch

    log("phase 6: shipping path (config.yaml as shipped: halo, INT8, HEAD_FOLD, bf16)")
    scfg = shipped.sps_config(1)
    log(f"  caps {scfg.caps.bricks} conv_mode {scfg.unet.conv_mode} int8 {scfg.unet.int8} "
        f"head_fold {scfg.unet.head_fold} dtype {scfg.unet.dtype} topo_every "
        f"{shipped.tpu.topo_every}")
    if not (scfg.unet.conv_mode == "halo" and scfg.unet.int8 and scfg.unet.head_fold):
        raise AssertionError("config/config.yaml is not the shipping configuration")
    (filt, run), halo_calls = count_halo_calls(lambda: drive(shipped, sd, stable, data))
    n_scans = len(data[0])
    run["p50"] = check_run(run, data[1], shipped.tpu.topo_every, card, "shipping path")
    check_launches(run, {"zband_conv": routes(),
                         "zband_conv_fused": routes(),
                         "brick_conv_int8": 0, "brick_conv_int8_gather": 10 * n_scans},
                   "shipping path")
    levels = filt._topo_cache[0]
    run["num_bricks"] = [int(lv.grid.num_bricks) for lv in levels[:3]]
    log(f"  num_bricks at L0-L2 in the last rebuild (scan 8): {run['num_bricks']} of "
        f"{list(scfg.caps.bricks[:3])} slots; bound of the ten int8 calls at these counts "
        f"{int8_path_bound(run['num_bricks'], scfg.caps.bricks):.3f} ms")
    # A rebuild and a reuse scan with the inputs already on the card under
    # sync debug mode "error": a call that waits for the device raises.
    filt.invalidate()
    on_card = [torch.as_tensor(a[:2], device="cuda") for a in data]
    pose = torch.eye(4, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(2):
            filt(on_card[0][i], on_card[1][i], on_card[2][i], pose)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log("  a rebuild and a reuse scan ran in sync debug mode 'error': no host sync")
    if profile:
        phase_profile(filt, data, card, "shipping path")
    del filt
    torch.cuda.empty_cache()
    (_, no_int8), twin_halo_calls = count_halo_calls(
        lambda: drive(twin(shipped, int8=False), sd, stable, data))
    log(f"  halo() calls over {n_scans} scans: {halo_calls} (int8), {twin_halo_calls} "
        f"(int8-off twin)")
    if twin_halo_calls - halo_calls != 10 * n_scans:
        raise AssertionError("shipping path: the int8 convs still assemble halos")
    _, f32 = drive(twin(shipped, int8=False, bf16=False), sd, stable, data)
    eps = shipped.threshold
    run["int8_vs_twin"] = compare_runs(run, no_int8, data[1], eps, 0.1,
                                       "shipping path (int8) vs its int8-off twin")
    run["twin_bf16_vs_f32"] = compare_runs(no_int8, f32, data[1], eps, 0.05,
                                           "int8-off twin bf16 vs f32")
    # The two bounds above add up to this one.
    run["int8_vs_f32"] = compare_runs(run, f32, data[1], eps, 0.15,
                                      "shipping path (int8, bf16) vs the f32 twin")
    return run


def phase_microbench(card, k3_f32):
    """K3 (the probe's Pallas conv) is the zband_conv kernel at k = 3, on
    the path of the port's microbenchmark. The microbenchmark sets TF32 off
    and raises when an output is not finite, a variant disagrees with the
    halo variant (bf16 within 2e-2, f32 within 1e-4 of the max-abs) or the
    kernel with zband_conv_ref (as in phase 2). Returns the bf16 and f32
    runs, with the kernel's launches in each as K3's; the f32 run's kernel
    is printed beside phase 2's times at K3's shape (`k3_f32`)."""
    from sps_torch.ops import zband_conv as zc
    from sps_torch.scripts import microbench_zband as mb

    log("phase 5: microbenchmark (K3)")
    runs = {}
    for dtype, iters in (("bf16", "16"), ("f32", "2")):
        zc.reset_launches()
        r = mb.main(["--dtype", dtype, "--iters", iters])
        launches = zc.LAUNCHES["zband_conv"]
        routes = dict(zc.ROUTE_LAUNCHES["zband_conv"])
        if launches <= 0:
            raise AssertionError(f"K3 ({dtype}): the zband_conv kernel was not launched")
        # bf16 at k = 3 takes the wgmma route, f32 the 3xTF32 one.
        route = "wgmma" if dtype == "bf16" else "wgmma_f32"
        if routes[route] != launches:
            raise AssertionError(f"K3 ({dtype}): launches per route {routes}, expected all "
                                 f"{launches} on {route}")
        runs[dtype] = dict(r, launches=launches, route=route)
    r = runs["bf16"]
    log(f"  bf16 [{card}]: " + ", ".join(
        f"{name} {v['ms']:.3f} ms" for name, v in r["variants"].items())
        + f", plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms ({r['bound_by']}); "
        f"launches {r['launches']} (bf16, {r['route']}), {runs['f32']['launches']} "
        f"(f32, {runs['f32']['route']})")
    f = runs["f32"]
    log(f"  f32 [{card}]: kernel-conv ({f['route']}) {f['variants']['kernel-conv']['ms']:.3f} ms, "
        f"F.conv2d f32 {f['variants']['conv2d']['ms']:.3f} ms, plain {f['plain_ms']:.3f} ms, "
        f"3xTF32 bound {f['bound_ms']:.3f} ms ({f['bound_by']}), FMA-only bound "
        f"{f['bound_fma_ms']:.3f} ms; phase 2 at this shape: wgmma_f32 {k3_f32['ms']:.3f} ms, "
        f"wmma {k3_f32['wmma_ms']:.3f} ms")
    return runs


def _device_us(evt) -> float:
    for key in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, key):
            return float(getattr(evt, key))
    return 0.0


def _incl_device_us(evt) -> float:
    for key in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, key):
            return float(getattr(evt, key))
    return 0.0


def _on_device(evt) -> bool:
    return str(getattr(evt, "device_type", "")).endswith("CUDA")


def profiled(step, n):
    """torch.profiler over step(i) for i < n, synchronised at the end.
    Returns the kernel events (device events outside the sps.* ranges),
    the sps.* ranges as {name: {count, host_us, kernel_us, span_us}} and
    the wall time in microseconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for i in range(n):
            step(i)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    ka = prof.key_averages()
    kernels = [e for e in ka if _on_device(e) and not e.key.startswith("sps.")]
    spans = {e.key: _device_us(e) for e in ka if _on_device(e) and e.key.startswith("sps.")}
    ranges = {e.key: dict(count=e.count, host_us=e.cpu_time_total, kernel_us=_incl_device_us(e),
                          span_us=spans.get(e.key, 0.0))
              for e in ka if not _on_device(e) and e.key.startswith("sps.")}
    return kernels, ranges, wall_us


def phase_profile(filt, data, card, label, n=8):
    """--profile: torch.profiler over n scans from a fresh rebuild (1
    rebuild + n-1 reuse at TOPO_EVERY 8): device busy share, kernel time and
    launches per scan, time per profiler range (sps.*) and the kernels that
    take the most device time."""
    scans, valids, labels = data
    pose = np.eye(4, dtype=np.float32)
    filt.invalidate()
    kernels, ranges, wall_us = profiled(lambda i: filt(scans[i], valids[i], labels[i], pose), n)
    busy = sum(_device_us(e) for e in kernels)
    launches = sum(e.count for e in kernels)
    log(f"profile ({label}): {n} scans, wall {wall_us / 1e3:.2f} ms, kernels "
        f"{busy / 1e3:.2f} ms ({busy / n / 1e3:.2f} ms per scan; device busy "
        f"{100 * busy / wall_us:.1f}%), {launches / n:.0f} kernel launches per scan [{card}]")
    for key in sorted(ranges):
        r = ranges[key]
        log(f"  range {key:24s} x{r['count']:2d}  host {r['host_us'] / 1e3:9.3f} ms  "
            f"kernels {r['kernel_us'] / 1e3:9.3f} ms  device span {r['span_us'] / 1e3:9.3f} ms")
    int8 = [e for e in kernels if "brick_int8" in e.key]
    log(f"  int8 conv kernels (brick_int8*): {sum(_device_us(e) for e in int8) / n / 1e3:.3f} ms "
        f"per scan, {sum(e.count for e in int8) / n:.0f} launches per scan, "
        f"{len(int8)} instances")
    for e in sorted(kernels, key=_device_us, reverse=True)[:20]:
        log(f"  kernel {_device_us(e) / 1e3:9.3f} ms x{e.count:5d}  {e.key[:100]}")


LOOP_POSE_TOL = 0.05  # m, phase 7's pose error against the trajectory's truth
LOOP_ROT_TOL = 0.5  # degrees
# Phase 7 seeds its first two scans this far from the truth: 0.3 m in the
# plane and 3 degrees of yaw.
LOOP_PRIOR_XY, LOOP_PRIOR_YAW_DEG = (0.24, 0.18), 3.0
# Phase 8 against sps_tpu's pin: per-scan translation, ATE and kept
# fraction (the H100 read at most 0.69 mm, 1.3e-5 m and 0.001).
LOC_POSE_TOL = 0.003
LOC_ATE_TOL = 0.001
LOC_KEPT_TOL = 0.005


def loop_prior():
    """Phase 7's seed pose for scans 0 and 1 (the truth is the identity)."""
    a = np.radians(LOOP_PRIOR_YAW_DEG)
    p = np.eye(4, dtype=np.float32)
    p[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    p[:2, 3] = LOOP_PRIOR_XY
    return p


def loop_profile(loop, on_card, prior, n, card, label):
    """torch.profiler over n scans of the loop from a fresh state (the
    first two seeded with `prior`): kernel time and launches per scan, and
    the kernel and host time under the sps.loop.filter and sps.loop.icp
    ranges."""
    scans, valids, labels = on_card
    loop.invalidate()
    kernels, ranges, _ = profiled(
        lambda i: loop(scans[i], valids[i], labels[i], prior=prior if i <= 1 else None), n)
    out = {"kernel_ms": sum(_device_us(e) for e in kernels) / n / 1e3,
           "kernel_launches": sum(e.count for e in kernels) / n}
    for name in ("filter", "icp"):
        r = ranges.get(f"sps.loop.{name}", dict(kernel_us=0.0, host_us=0.0))
        out[f"{name}_ms"] = r["kernel_us"] / n / 1e3
        out[f"{name}_host_ms"] = r["host_us"] / n / 1e3
    log(f"  {label} profile [{card}]: kernels {out['kernel_ms']:.2f} ms a scan (filter "
        f"{out['filter_ms']:.2f}, ICP {out['icp_ms']:.2f}), "
        f"{out['kernel_launches']:.0f} launches a scan; host time in the ranges: filter "
        f"{out['filter_host_ms']:.2f}, ICP {out['icp_host_ms']:.2f} ms a scan")
    return out


def phase_loop(card, shipped, sd, stable, data):
    """The localization loop on the shipping path: LocalizationLoop at
    config/config.yaml as shipped over the BLT-scale scans (in the map
    frame: the truth is the identity for every scan), refine on, then off.
    The first two calls take loop_prior() (0.3 m and 3 degrees of yaw off
    the truth), the rest the cv prior; every reuse call runs under sync
    debug mode "error"; the int8 gather form must launch 10 times a filter
    pass; every pose within LOOP_POSE_TOL and LOOP_ROT_TOL of the truth,
    so the ICP has to take the seeded scans back to it. Prints the
    synchronised per-scan p50, peak memory, and the profiler's kernel time
    and launches a scan with the filter / ICP split."""
    import torch

    from sps_torch.ops import brick_conv_int8 as bi8
    from sps_torch.stream.loop import LocalizationLoop

    log("phase 7: localization loop on the shipping path (config.yaml as shipped, "
        "filter -> ICP)")
    scans, valids, labels = data
    on_card = [torch.as_tensor(a, device="cuda") for a in (scans, valids, labels)]
    prior = torch.as_tensor(loop_prior(), device="cuda")
    n_scans = len(scans)
    log(f"  scans 0-1 seeded {np.linalg.norm(LOOP_PRIOR_XY):.2f} m and "
        f"{LOOP_PRIOR_YAW_DEG:g} deg of yaw off the truth")
    runs = {}
    for refine in (True, False):
        label = "loop, refine" if refine else "loop, no refine"
        t0 = time.time()
        loop = LocalizationLoop(shipped, sd, stable, refine=refine)
        torch.cuda.synchronize()
        build_s = time.time() - t0
        topo = loop.filt.topo_every
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        lat, errs, rots, passes = [], [], [], 0
        for i in range(n_scans):
            reuse = i % topo != 0
            torch.cuda.synchronize()
            t = time.perf_counter()
            if reuse:
                torch.cuda.set_sync_debug_mode("error")
            try:
                pose, keep, st = loop(on_card[0][i], on_card[1][i], on_card[2][i],
                                      prior=prior if i <= 1 else None)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t) * 1e3)
            passes += 2 if refine else 1
            p = pose.cpu().numpy()
            errs.append(float(np.linalg.norm(p[:3, 3])))
            rots.append(float(np.degrees(np.arccos(np.clip((np.trace(p[:3, :3]) - 1) / 2,
                                                           -1, 1)))))
            if not np.isfinite(p).all() or bool(st["overflow"]):
                raise AssertionError(f"{label} scan {i}: pose not finite or overflow")
            if int(st["n_kept"]) <= 0 or int(st["inliers"]) <= 0:
                raise AssertionError(f"{label} scan {i}: nothing kept or no inlier")
        gather = bi8.GATHER_LAUNCHES["brick_conv_int8_gather"]
        peak = torch.cuda.max_memory_allocated()
        p50 = statistics.median(lat)
        log(f"  {label}: map digest {build_s:.1f} s; per-scan latency ms "
            f"{[round(x, 2) for x in lat]}; p50 {p50:.2f} ms; peak device memory "
            f"{peak / 2**30:.2f} GiB [{card}]")
        log(f"  {label}: translation error m {errs}, rotation error deg {rots}; {passes} filter passes, brick_conv_int8_gather launches "
            f"{gather} (expected {10 * passes}), halo form {bi8.LAUNCHES['brick_conv_int8']}")
        log(f"  {n_scans - (n_scans + topo - 1) // topo} reuse calls ran in sync debug mode "
            f"'error': no host sync")
        if gather != 10 * passes or bi8.LAUNCHES["brick_conv_int8"] != 0:
            raise AssertionError(f"{label}: int8 launches {gather}, expected {10 * passes}")
        if not (max(errs) < LOOP_POSE_TOL and max(rots) < LOOP_ROT_TOL):
            raise AssertionError(f"{label}: pose error {max(errs)} m, {max(rots)} deg exceeds "
                                 f"{LOOP_POSE_TOL} m, {LOOP_ROT_TOL} deg")
        prof = loop_profile(loop, on_card, prior, min(8, n_scans), card, label)
        runs["refine" if refine else "norefine"] = dict(
            p50=p50, lat=lat, peak=peak, launches=gather, passes=passes, max_err_m=max(errs),
            max_rot_deg=max(rots), **prof)
        del loop
        torch.cuda.empty_cache()
    return runs


def phase_trained(card, root):
    """Trained localization: the movers dataset under `root`
    (config_loc_movers.yaml's recipe, generated by the port,
    movers_data), ckpt_loc_movers_v2 from its npz under
    config_loc_movers_v2.yaml at epsilon 0.99, run_localization with raw,
    sps and oracle (prior odom, init_noise 0.05, refine) on 20220629 and
    20220629_clean, held against sps_tpu's pinned poses, ATEs and kept
    fractions (LOC_POSE_TOL, LOC_ATE_TOL, LOC_KEPT_TOL); sps must beat raw
    on 20220629."""
    import torch

    from sps_torch import config
    from sps_torch.convert import ASSETS, load_npz
    from sps_torch.stream.localize import run_localization

    log("phase 8: trained localization (ckpt_loc_movers_v2, movers sequences)")
    pin = np.load(os.path.join(ASSETS, "loc_movers_v2_pin.npz"))
    n = int(pin["scans"])
    cfg = dataclasses.replace(
        config.load(os.path.join(HERE, "config", "config_loc_movers_v2.yaml"), data_root=root),
        threshold=float(pin["epsilon"]))
    sd = load_npz(os.path.join(ASSETS, "ckpt_loc_movers_v2.npz"))
    log(f"  {n} scans a sequence; epsilon "
        f"{cfg.threshold}, conv_mode {cfg.tpu.conv_mode}, int8 {cfg.tpu.int8}, dist_feature "
        f"{cfg.dist_feature}, bf16 {cfg.tpu.bf16}, topo_every {cfg.tpu.topo_every}")
    cache, out = {}, {}
    for seq in ("20220629", "20220629_clean"):
        for mode in ("raw", "sps", "oracle"):
            key = f"{seq}/{mode}"
            torch.cuda.synchronize()
            t = time.time()
            r = run_localization(cfg, sd, seq, mode, prior="odom", init_noise=0.05,
                                 refine=True, seed=0, cache=cache, log=lambda _m: None)
            secs = time.time() - t
            want = pin[key + "/poses"]
            gap = np.linalg.norm(r["poses"][:, :3, 3] - want[:, :3, 3], axis=-1)
            ate_pin = float(pin[key + "/ate"])
            ate_gap = abs(r["ate_rmse"] - ate_pin)
            kept_pin = float(pin[key + "/kept_frac_mean"])
            kept_gap = abs(r["kept_frac_mean"] - kept_pin)
            out[key] = dict(ate=r["ate_rmse"], ate_pin=ate_pin, ate_gap_m=ate_gap,
                            kept=r["kept_frac_mean"], kept_pin=kept_pin, kept_gap=kept_gap,
                            max_pose_gap_m=float(gap.max()), s=secs)
            log(f"  {key}: ATE {r['ate_rmse']} m (sps_tpu pin {ate_pin}, gap {ate_gap}), "
                f"kept {r['kept_frac_mean']} (pin {kept_pin}, gap {kept_gap}), pose gap to "
                f"the pin max {gap.max()} m, mean {gap.mean()} m; {secs:.1f} s")
            if not np.isfinite(r["poses"]).all() or gap.max() > LOC_POSE_TOL:
                raise AssertionError(f"{key}: a pose is {gap.max()} m from sps_tpu's "
                                     f"(tolerance {LOC_POSE_TOL})")
            if ate_gap > LOC_ATE_TOL or kept_gap > LOC_KEPT_TOL:
                raise AssertionError(f"{key}: ATE {r['ate_rmse']}, kept {r['kept_frac_mean']} "
                                     f"against the pin's {ate_pin}, {kept_pin}")
    log(f"  ATE m [{card}]: " + ", ".join(f"{k} {v['ate']:.4f}" for k, v in out.items()))
    if not out["20220629/sps"]["ate"] < out["20220629/raw"]["ate"]:
        raise AssertionError("20220629: sps does not beat raw")
    return out


# Phase 11 (the baselines) against sps_tpu's pin: per-scan translation, ATE
# and kept fraction at phase 8's LOC_* tolerances. The first scan's model
# outputs: MOS4D computes in bf16 (sps_tpu feeds its MinkUNet the bf16
# occupancy), so its logits are held within BASELINE_MOS4D_BAND of the
# largest |logit| (on 20220629's first scan the port on the CPU read 0.254
# of 9.125, 2.8%, from sps_tpu, the card 0.066 from the CPU); MapMOS (f32)
# within BASELINE_MAPMOS_TOL of it; LTS scores (f32, in [0, 1]) within
# BASELINE_LTS_TOL. Decisions (logit <= 0, score <= epsilon) must agree
# except within that tolerance of the threshold.
BASELINE_MOS4D_BAND = 2.0**-4
BASELINE_MAPMOS_TOL = 1e-3
BASELINE_LTS_TOL = 1e-4
BASELINE_FILTERS = ("mask", "mos4d", "mapmos", "lts")
# MOS4D's registration is chaotic in its keep mask: on 20220629's first scan
# 5 of 5,014 kept points flipped within the bf16 band move the first
# registration by 13 cm (the port's ICP on sps_tpu's keep mask lands within
# 0.01 mm of sps_tpu's pose). So MOS4D is held at LOC_* on sps_tpu's
# trajectory (pinned: every call runs the port's MOS4D at the pin's pose,
# its decisions must equal the pin's outside the bf16 band, and the call
# returns the pin's keep mask), and its free run's ATE within
# BASELINE_FREE_ATE_TOL of the pin's.
BASELINE_FREE_ATE_TOL = 0.02


def pinned(filt, calls):
    """Teacher forcing of a MOS4D filter along a pinned run: `calls` =
    (poses, point counts, packed keep masks) of sps_tpu's filter calls.
    Returns a filter of filt's class (state shared) whose i-th call runs the
    port's model (push) at the pin's i-th pose, so that its buffer holds
    what sps_tpu's held, records the gap between the pose it was given and
    the pin's, the decisions that differ from the pin's and those of them
    outside BASELINE_MOS4D_BAND of the largest |logit|, and returns the
    pin's keep mask."""
    poses, counts, keeps = calls

    class Pinned(type(filt)):
        def __call__(self, scan_xyz, pose):
            i = len(self.record)
            lg = self.push(scan_xyz, poses[i]).float().cpu().numpy()
            want = np.unpackbits(keeps[i])[:counts[i]].astype(bool)
            if len(lg) != len(want):
                raise AssertionError(f"call {i}: {len(lg)} points, the pin's {len(want)}")
            band = BASELINE_MOS4D_BAND * float(np.abs(lg).max())
            diff = (lg <= 0) != want
            self.record.append(dict(
                pose_gap_m=float(np.abs(np.asarray(pose)[:3, 3] - poses[i][:3, 3]).max()),
                flips=int(diff.sum()), flips_outside_band=int((diff & (np.abs(lg) > band)).sum()),
                n=len(lg)))
            return want

    out = Pinned.__new__(Pinned)
    out.__dict__.update(filt.__dict__)
    out.record = []
    return out


def check_first_scan(name, got, want, tol, threshold):
    """Model outputs against the pin: |got - want| <= tol, and the same side
    of `threshold` wherever the pin lies farther than tol from it."""
    err = float(np.abs(got - want).max())
    far = np.abs(want - threshold) > tol
    flips = int(((got <= threshold) != (want <= threshold))[far].sum())
    near = int((~far).sum())
    log(f"  first scan {name}: max |d| {err:.3g} (tolerance {tol:.3g}; max |pin| "
        f"{float(np.abs(want).max()):.3g}), {near} of {len(want)} within the tolerance of "
        f"{threshold}, {flips} decisions flipped outside it")
    if not np.isfinite(got).all() or err > tol or flips:
        raise AssertionError(f"first scan {name}: max |d| {err} (tolerance {tol}), {flips} flips")
    return {"max_abs_err": err, "tol": tol, "near_threshold": near}


def phase_baselines(card, root, profile):
    """The baseline filters in the localization driver on the movers data
    under `root` (phase 8's): (11a) the first scan of 20220629 at its
    ground-truth pose through MOS4D (the scan alone in its 4-scan buffer),
    MapMOS (counter 0, its 30 m crop subsampled as sps_tpu does) and LTS
    (its range-image windows), from the round-5 checkpoints
    (sps_torch/assets/baselines_r5_*.npz), held against sps_tpu's outputs
    in loc_baselines_pin.npz; (11b) run_localization with mask, mos4d,
    mapmos and lts (config_loc_movers_v2.yaml at epsilon 0.99, prior odom,
    init_noise 0.05, refine, seed 0, one cache across the runs as the pin's)
    on 20220629 and 20220629_clean, each scan's translation, the ATE and
    the kept fraction against the pin (LOC_* tolerances), MOS4D pinned to
    sps_tpu's keep masks (`pinned`: its own decisions must equal the pin's
    outside the bf16 band at every call), then MOS4D's free run (ATE within
    BASELINE_FREE_ATE_TOL of the pin's); p50 ms a scan (filter and
    registration) and peak memory; no kernel of sps_torch/csrc runs on this
    path (every launch count stays 0). The f32 convs and
    matmuls of MapMOS and LTS compare like for like because phase 2 turned
    TF32 off for the rest of the process; the phase checks that it still
    is. --profile: kernel ms and launches a scan of each filter."""
    import torch

    from sps_torch import config
    from sps_torch.convert import ASSETS
    from sps_torch.data import blt
    from sps_torch.data import range_image as ri
    from sps_torch.stream import localize as loc

    log("phase 11: baselines (mask, MOS4D, MapMOS, LTS) in the localization driver")
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 is on: phase 2 turns it off for the f32 comparisons")
    pin = np.load(os.path.join(ASSETS, "loc_baselines_pin.npz"))
    n_pin = int(pin["scans"])
    cfg = dataclasses.replace(
        config.load(os.path.join(HERE, "config", "config_loc_movers_v2.yaml"), data_root=root),
        threshold=float(pin["epsilon"]))
    mp = blt.load_map(root, cfg.data.map_file)
    ns = cfg.tpu.scan_points
    scans, _ = blt.load_sequences_raw(root, ["20220629"])
    scan0 = scans[0][:ns].astype(np.float32)
    world = torch.as_tensor(pin["first_scan/world"], device="cuda")
    pose0 = pin["first_scan/pose"]
    n0 = len(scan0)
    first, filter_ms = {}, {}
    reset_counts()
    for mode in ("mos4d", "mapmos", "lts"):
        filt = loc._make_baseline_filter(cfg, mode, mp, weights_dir=ASSETS)
        if mode == "mos4d":
            filt.buffer = [world]

            def fn():
                return filt.logits()[:n0]
        elif mode == "mapmos":
            local = filt.local_map(pose0[:3, 3])

            def fn():
                return filt.logits(world, local)[:n0]
        else:
            wins, _ = ri.windows(ri.project(scan0, filt.lidar), filt.lidar)

            def fn():
                return filt.scores(wins)
        got = fn().float().cpu().numpy()
        want = pin[f"first_scan/{mode}/" + ("scores" if mode == "lts" else "logits")]
        if mode == "mos4d":
            tol = BASELINE_MOS4D_BAND * float(np.abs(want).max())
        elif mode == "mapmos":
            tol = BASELINE_MAPMOS_TOL * float(np.abs(want).max())
        else:
            tol = BASELINE_LTS_TOL
        first[mode] = check_first_scan(mode, got.reshape(-1), want.reshape(-1), tol,
                                       cfg.threshold if mode == "lts" else 0.0)
        filter_ms[mode] = time_ms(fn, runs=10, warmup=2)
        del filt
    mask = loc.bl.MaskFilter(mp, cfg.voxel_size)
    sx0 = torch.as_tensor(scan0[:, :3], device="cuda")
    p0 = torch.as_tensor(pose0, device="cuda")
    filter_ms["mask"] = time_ms(lambda: mask.keep(sx0, p0), runs=10, warmup=2)
    log(f"  filter alone on the first scan [{card}]: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in filter_ms.items()))

    def localize(seq, mode, cache):
        """One run_localization under the pin's protocol, timed: (result,
        per-scan ms, peak bytes, seconds)."""
        stamps = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        r = loc.run_localization(cfg, None, seq, mode, prior="odom", init_noise=0.05,
                                 refine=True, seed=0, baseline_weights=ASSETS, cache=cache,
                                 log=lambda _m: stamps.append(time.perf_counter()))
        secs = time.perf_counter() - t
        return r, np.diff([t] + stamps) * 1e3, torch.cuda.max_memory_allocated(), secs

    def against_pin(key, r):
        want = pin[key + "/poses"]
        if r["poses"].shape != want.shape or len(want) != n_pin:
            raise AssertionError(f"{key}: {r['poses'].shape} poses, the pin has {want.shape}")
        gap = np.linalg.norm(r["poses"][:, :3, 3] - want[:, :3, 3], axis=-1)
        ate_pin = float(pin[key + "/ate"])
        kept_pin = float(pin[key + "/kept_frac_mean"])
        return dict(ate=r["ate_rmse"], ate_pin=ate_pin, ate_gap_m=abs(r["ate_rmse"] - ate_pin),
                    kept=r["kept_frac_mean"], kept_pin=kept_pin,
                    kept_gap=abs(r["kept_frac_mean"] - kept_pin),
                    max_pose_gap_m=float(gap.max()), mean_pose_gap_m=float(gap.mean()),
                    finite=bool(np.isfinite(r["poses"]).all()))

    cache, out, free = {}, {}, {}
    mos4d = loc._make_baseline_filter(cfg, "mos4d", mp, weights_dir=ASSETS)
    for seq in ("20220629", "20220629_clean"):
        for mode in BASELINE_FILTERS:
            key = f"{seq}/{mode}"
            if mode == "mos4d":
                cache["mos4d"] = pinned(mos4d, (pin[key + "/call_poses"], pin[key + "/call_n"],
                                                pin[key + "/call_keeps"]))
            r, per_scan, peak, secs = localize(seq, mode, cache)
            res = out[key] = dict(**against_pin(key, r), s=secs, p50_ms=float(np.median(per_scan)),
                                  peak=peak)
            note = ""
            if mode == "mos4d":
                rec = cache["mos4d"].record
                if len(rec) != len(pin[key + "/call_n"]):
                    raise AssertionError(f"{key}: {len(rec)} filter calls, the pin's "
                                         f"{len(pin[key + '/call_n'])}")
                res["pinned"] = dict(calls=len(rec), flips=sum(c["flips"] for c in rec),
                                     flips_outside_band=sum(c["flips_outside_band"] for c in rec),
                                     points=sum(c["n"] for c in rec),
                                     max_call_pose_gap_m=max(c["pose_gap_m"] for c in rec))
                note = (f" (pinned: {res['pinned']['flips']} of {res['pinned']['points']} "
                        f"decisions differ from the pin's over {len(rec)} calls, "
                        f"{res['pinned']['flips_outside_band']} outside the bf16 band; the "
                        f"driver's call poses within {res['pinned']['max_call_pose_gap_m']:.3g} m "
                        f"of the pin's)")
            log(f"  {key}: ATE {res['ate']} m (sps_tpu pin {res['ate_pin']}, gap "
                f"{res['ate_gap_m']}), kept {res['kept']} (pin {res['kept_pin']}, gap "
                f"{res['kept_gap']}), pose gap to the pin max {res['max_pose_gap_m']} m, mean "
                f"{res['mean_pose_gap_m']} m; p50 {res['p50_ms']:.2f} ms a scan, peak "
                f"{peak / 2**30:.2f} GiB, {secs:.1f} s{note} [{card}]")
            if not res["finite"] or res["max_pose_gap_m"] > LOC_POSE_TOL:
                raise AssertionError(f"{key}: a pose is {res['max_pose_gap_m']} m from sps_tpu's "
                                     f"(tolerance {LOC_POSE_TOL})")
            if res["ate_gap_m"] > LOC_ATE_TOL or res["kept_gap"] > LOC_KEPT_TOL:
                raise AssertionError(f"{key}: ATE {res['ate']}, kept {res['kept']} against the "
                                     f"pin's {res['ate_pin']}, {res['kept_pin']}")
            if mode == "mos4d" and res["pinned"]["flips_outside_band"]:
                raise AssertionError(f"{key}: MOS4D decisions differ from sps_tpu's outside the "
                                     f"bf16 band: {res['pinned']}")
        # MOS4D's free run (its own decisions) on the same sequence.
        key = f"{seq}/mos4d"
        r, per_scan, peak, secs = localize(seq, "mos4d", {"vmaps": cache["vmaps"]})
        res = free[key] = dict(**against_pin(key, r), s=secs, p50_ms=float(np.median(per_scan)),
                               peak=peak)
        log(f"  {key} (free run): ATE {res['ate']} m (pin {res['ate_pin']}, gap "
            f"{res['ate_gap_m']}; tolerance {BASELINE_FREE_ATE_TOL}), kept {res['kept']} (pin "
            f"{res['kept_pin']}), pose gap to the pin max {res['max_pose_gap_m']} m, mean "
            f"{res['mean_pose_gap_m']} m; p50 {res['p50_ms']:.2f} ms a scan, peak "
            f"{peak / 2**30:.2f} GiB [{card}]")
        if not res["finite"] or res["ate_gap_m"] > BASELINE_FREE_ATE_TOL:
            raise AssertionError(f"{key} (free run): ATE {res['ate']} against the pin's "
                                 f"{res['ate_pin']}")
    launched = {k: v for k, v in read_counts().items()
                if (sum(v.values()) if isinstance(v, dict) else v)}
    if launched:
        raise AssertionError(f"a kernel of sps_torch/csrc ran on the baselines' path: {launched}")
    prof = {}
    if profile:
        scans, gts = blt.load_sequences_raw(root, ["20220629"])
        for mode in BASELINE_FILTERS:
            filt = mask if mode == "mask" else loc._make_baseline_filter(cfg, mode, mp,
                                                                         weights_dir=ASSETS)

            def step(i, filt=filt, mode=mode):
                s = scans[i][:ns].astype(np.float32)
                return filt(s) if mode == "lts" else filt(s[:, :3], gts[i].astype(np.float32))

            step(0)
            kernels, _, wall_us = profiled(step, 4)
            prof[mode] = {"kernel_ms": sum(_device_us(e) for e in kernels) / 4e3,
                          "launches": sum(e.count for e in kernels) / 4, "wall_ms": wall_us / 4e3}
            log(f"  profile {mode} [{card}]: kernels {prof[mode]['kernel_ms']:.3f} ms a scan, "
                f"{prof[mode]['launches']:.0f} launches a scan, wall {prof[mode]['wall_ms']:.2f} "
                f"ms a scan; top: " + "; ".join(
                    f"{e.key[:48]} {_device_us(e) / 4e3:.3f} ms"
                    for e in sorted(kernels, key=_device_us, reverse=True)[:4]))
            del filt
    del mask, mos4d, cache
    torch.cuda.empty_cache()
    return {"first_scan": first, "filter_ms": filter_ms, "runs": out, "mos4d_free": free,
            "profile": prof}


# Phase 9 (offline). 9a: the gate of tests/test_int8_parity.py (float
# uIoU above GATE_FLOAT_MIN, each int8 run within GATE_INT8_TOL of the float
# run) and each uIoU within GATE_PIN_TOL of sps_tpu's pin.
GATE_FLOAT_MIN = 0.5
GATE_INT8_TOL = 0.005
GATE_PIN_TOL = 0.005
GATE_RUNS = {"float": {}, "int8": dict(int8=True), "int8_head_fold": dict(int8=True,
                                                                           head_fold=True)}
# 9b: each mean metric of predict_sequence against sps_tpu's pin (bf16 on
# both sides; the gate's half point of uIoU; the H100 read at most 1e-4).
PREDICT_TOL = 0.005
PREDICT_RUNS = {"v1": ("ckpt_loc_movers.npz", "config_loc_movers.yaml"),
                "v2": ("ckpt_loc_movers_v2.npz", "config_loc_movers_v2.yaml")}
BLT_SEQ = "blt_scale"


def movers_data(n):
    """The movers dataset (config_loc_movers.yaml's recipe, n scans a
    sequence) written by the port under build/movers; returns its root."""
    from sps_torch.data import synthetic

    root = os.path.join(HERE, "build", "movers")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.time()
    synthetic.generate_dense(root, **dict(synthetic.MOVERS, scans_per_seq=n))
    log(f"movers dataset: {n} scans a sequence, generated in {time.time() - t0:.1f} s")
    return root


def write_blt(root, seq, stable, data):
    """Phase 6's map and scans on disk in the BLT layout: the map as
    base_map.asc.npy, each scan's valid rows as [x, y, z, label], identity
    poses and map transform (the scans are in the map frame)."""
    scans, valids, labels = data
    sdir = os.path.join(root, "sequence", seq)
    for sub in ("maps", os.path.join("sequence", seq, "scans"),
                os.path.join("sequence", seq, "poses")):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    np.save(os.path.join(root, "maps", "base_map.asc.npy"),
            np.concatenate([stable, np.zeros((len(stable), 1), np.float32)], 1))
    np.savetxt(os.path.join(sdir, "map_transform"), np.eye(4), delimiter=",")
    for i in range(len(scans)):
        v = valids[i]
        np.save(os.path.join(sdir, "scans", f"{i:06d}.npy"),
                np.concatenate([scans[i][v], labels[i][v][:, None]], 1).astype(np.float32))
        np.savetxt(os.path.join(sdir, "poses", f"{i:06d}.txt"), np.eye(4), delimiter=",")


def recorded(fn):
    """fn wrapped to record each call: its synchronised time in ms, and the
    scan rows' scores, overflow flags and metrics of predict_step's result."""
    import torch

    calls = []

    def wrapper(model, batch, map_points, map_vm=None, *, cfg):
        torch.cuda.synchronize()
        t = time.perf_counter()
        scores, scan_mask, m = fn(model, batch, map_points, map_vm, cfg=cfg)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        ns = cfg.tpu.scan_points
        calls.append(dict(ms=ms, scores=scores[:ns].float().cpu().numpy(),
                          valid=batch["valid"][0].cpu().numpy(),
                          **{k: float(v) for k, v in m.items()}))
        return scores, scan_mask, m

    return wrapper, calls


def predicted(cfg, sd):
    """eval.predict_sequence on the card with every launch count set to 0
    just before and read just after; returns (means, per-scan records,
    launches, peak device memory)."""
    import torch

    from sps_torch import eval as ev

    real = ev.predict_step
    ev.predict_step, calls = recorded(real)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        means = ev.predict_sequence(cfg, sd)
        torch.cuda.synchronize()
        launches = read_counts()
    finally:
        ev.predict_step = real
    return means, calls, launches, torch.cuda.max_memory_allocated()


def phase_gate(card):
    """9a: the trained int8 gate. The v1 checkpoint under
    config_loc_movers.yaml at the pin's epsilon on the gate's six scans of
    20220608 (generated alone), StreamingFilter float, INT8 and INT8 +
    HEAD_FOLD; TP/FP/FN summed over the scans (score > eps against label >
    eps, as tests/test_int8_parity.py::_uiou)."""
    import torch

    from sps_torch import config
    from sps_torch.convert import ASSETS, load_npz
    from sps_torch.data import blt, synthetic
    from sps_torch.ops import brick_conv_int8 as bi8
    from sps_torch.stream.engine import StreamingFilter

    log("phase 9a: the int8 parity gate on the trained v1 checkpoint")
    pin = np.load(os.path.join(ASSETS, "int8_parity_pin.npz"))
    eps = float(pin["epsilon"])
    root = os.path.join(HERE, "build", "parity")
    shutil.rmtree(root, ignore_errors=True)
    try:
        synthetic.generate_dense(root, **synthetic.PARITY)
        seq = synthetic.PARITY["sequences"][0]
        base = dataclasses.replace(
            config.load(os.path.join(HERE, "config", "config_loc_movers.yaml"), data_root=root),
            threshold=eps)
        scans, poses = blt.load_sequences_raw(root, [seq])
        mp = blt.load_map(root, base.data.map_file)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    sd = load_npz(os.path.join(ASSETS, "ckpt_loc_movers.npz"))
    ns = base.tpu.scan_points
    out = {}
    for run, opts in GATE_RUNS.items():
        cfg = twin(base, **opts)
        filt = StreamingFilter(cfg, sd, mp)
        torch.cuda.synchronize()
        reset_counts()
        tp = fp = fn = 0
        gaps = []
        for i, (scan, pose) in enumerate(zip(scans, poses)):
            n = min(len(scan), ns)
            sx = np.zeros((ns, 3), np.float32)
            sl = np.zeros(ns, np.float32)
            sv = np.zeros(ns, bool)
            sx[:n], sl[:n], sv[:n] = scan[:n, :3], scan[:n, 3], True
            scores, _, _ = filt(sx, sv, sl, pose.astype(np.float32))
            s = scores.float().cpu().numpy()
            if not (np.isfinite(s).all() and (s[sv] > 0).all() and s.max() <= 1):
                raise AssertionError(f"9a {run} scan {i}: scores not finite or outside (0, 1]")
            pred, true = s[sv] > eps, sl[sv] > eps
            tp += int((pred & true).sum())
            fp += int((pred & ~true).sum())
            fn += int((~pred & true).sum())
            gaps.append(float(np.abs(s - pin[f"{run}/scores"][i])[sv].max()))
        launches = bi8.GATHER_LAUNCHES["brick_conv_int8_gather"]
        want = 10 * len(scans) if opts.get("int8") else 0
        uiou = tp / max(tp + fn + fp, 1)
        pin_uiou = float(pin[f"{run}/uiou"])
        out[run] = dict(uiou=uiou, pin_uiou=pin_uiou, tp=tp, fp=fp, fn=fn, launches=launches,
                        max_dscore_vs_pin=max(gaps))
        log(f"  {run}: uIoU {uiou} (TP {tp}, FP {fp}, FN {fn}; sps_tpu pin {pin_uiou}, gap "
            f"{abs(uiou - pin_uiou)}); max |dscore| against the pin per scan {gaps}; "
            f"brick_conv_int8_gather launches {launches} (expected {want}) [{card}]")
        if launches != want or bi8.LAUNCHES["brick_conv_int8"] != 0:
            raise AssertionError(f"9a {run}: int8 launches {launches}, expected {want}")
        if abs(uiou - pin_uiou) > GATE_PIN_TOL:
            raise AssertionError(f"9a {run}: uIoU {uiou} is more than {GATE_PIN_TOL} from "
                                 f"sps_tpu's {pin_uiou}")
        del filt
    if not out["float"]["uiou"] > GATE_FLOAT_MIN:
        raise AssertionError(f"9a: float uIoU {out['float']['uiou']} <= {GATE_FLOAT_MIN}")
    for run in [r for r in GATE_RUNS if r != "float"]:
        d = abs(out[run]["uiou"] - out["float"]["uiou"])
        log(f"  |uIoU({run}) - uIoU(float)| = {d} (bound {GATE_INT8_TOL})")
        if d > GATE_INT8_TOL:
            raise AssertionError(f"9a: {run} moves uIoU by {d} > {GATE_INT8_TOL}")
    torch.cuda.empty_cache()
    return out


def phase_predict_trained(card, movers_root):
    """9b: predict_sequence with the trained checkpoints on 20220629 of the
    movers data, against sps_tpu's pin."""
    from sps_torch import config
    from sps_torch.convert import ASSETS, load_npz

    log("phase 9b: predict with trained weights (movers 20220629)")
    pin = np.load(os.path.join(ASSETS, "predict_pin.npz"))
    out = {}
    for tag, (weights, cfg_name) in PREDICT_RUNS.items():
        cfg = config.load(os.path.join(HERE, "config", cfg_name), data_root=movers_root)
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, test=("20220629",)))
        means, calls, launches, peak = predicted(cfg, load_npz(os.path.join(ASSETS, weights)))
        if len(calls) != int(pin["scans"]):
            raise AssertionError(f"9b {tag}: {len(calls)} scans, the pin has {int(pin['scans'])}")
        gaps = {k: abs(means[k] - float(np.mean(pin[f"{tag}/{k}"]))) for k in
                ("Loss", "R2", "dIoU", "Precision", "Recall", "F1")}
        ovf = [bool(c["overflow"]) for c in calls]
        ovf_pin = [bool(x) for x in pin[f"{tag}/overflow"]]
        dscore = max(float(np.abs(c["scores"] - pin[f"{tag}/scores"][i])[c["valid"]].max())
                     for i, c in enumerate(calls))
        out[tag] = dict(means=means, gaps=gaps, overflow_scans=sum(ovf),
                        max_dscore_vs_pin=dscore, ms_p50=statistics.median(
                            [c["ms"] for c in calls[1:]]))
        log(f"  {tag} ({cfg_name}): " + ", ".join(f"{k} {v:.4f} (gap {gaps[k]:.4f})"
                                                 for k, v in means.items() if k in gaps)
            + f"; overflow on {sum(ovf)} scans (pin {sum(ovf_pin)}); max |dscore| against "
            f"the pin {dscore:.4f}; predict_step p50 {out[tag]['ms_p50']:.2f} ms [{card}]")
        if max(gaps.values()) > PREDICT_TOL:
            raise AssertionError(f"9b {tag}: a mean metric is more than {PREDICT_TOL} from "
                                 f"sps_tpu's: {gaps}")
        # The configuration's 25.6 m atlas window does not hold a movers scan:
        # sps_tpu flags the same overflow on the same scans.
        if ovf != ovf_pin:
            raise AssertionError(f"9b {tag}: overflow flags {ovf} differ from the pin's {ovf_pin}")
        if launches["brick_conv_int8_gather"] != 0:
            raise AssertionError(f"9b {tag}: an int8 kernel ran with INT8 off")
    return out


def predict_profile(cfg, sd, card, n=8):
    """--profile: torch.profiler over predict_step on the first n scans of
    the test split: device busy share, kernel time and launches a scan, and
    the time under the sps.assemble / sps.model ranges."""
    import torch

    from sps_torch import eval as ev
    from sps_torch.data.blt import BLTDataModule
    from sps_torch.models.spsnet import SPSModel

    model = SPSModel(cfg.sps_config(1))
    model.load_state_dict(sd, strict=True)
    model.cuda().eval()
    dm = BLTDataModule(cfg, test=True)
    mp = torch.as_tensor(dm.map_points, device="cuda")
    batches = [{k: torch.as_tensor(v, device="cuda") for k, v in b.items() if k != "indices"}
               for b in dm.batches(dm.test, 1, shuffle=False)][:n]
    n = len(batches)

    def step(i):
        with torch.inference_mode():
            ev.predict_step(model, batches[i], mp, cfg=cfg)

    step(0)
    kernels, ranges, wall_us = profiled(step, n)
    busy = sum(_device_us(e) for e in kernels)
    log(f"profile (offline predict_step): {n} scans, wall {wall_us / 1e3:.2f} ms, kernels "
        f"{busy / n / 1e3:.2f} ms a scan (device busy {100 * busy / wall_us:.1f}%), "
        f"{sum(e.count for e in kernels) / n:.0f} launches a scan [{card}]")
    for key in sorted(ranges):
        r = ranges[key]
        log(f"  range {key:14s} host {r['host_us'] / n / 1e3:8.3f} ms  kernels "
            f"{r['kernel_us'] / n / 1e3:8.3f} ms a scan")
    for e in sorted(kernels, key=_device_us, reverse=True)[:12]:
        log(f"  kernel {_device_us(e) / n / 1e3:8.3f} ms a scan x{e.count / n:6.1f}  {e.key[:90]}")


def phase_predict_blt(card, shipped, sd, stable, data, profile):
    """9c: predict_sequence at config/config.yaml as shipped on phase 6's
    scans and map written to disk (BLT layout), then its int8-off twin.
    9d: replay_sequence over the same sequence, against a fresh
    StreamingFilter called directly on the same scans."""
    import torch

    from sps_torch.data import blt
    from sps_torch.stream import replay as rp
    from sps_torch.stream.engine import StreamingFilter

    log("phase 9c: predict at config.yaml as shipped, BLT scale, from disk")
    root = os.path.join(HERE, "build", "blt")
    shutil.rmtree(root, ignore_errors=True)
    write_blt(root, BLT_SEQ, stable, data)
    cfg = dataclasses.replace(shipped, data=dataclasses.replace(
        shipped.data, root=root, test=(BLT_SEQ,)))
    n_scans = len(data[0])
    try:
        means, calls, launches, peak = predicted(cfg, sd)
        _, twin_calls, twin_launches, _ = predicted(twin(cfg, int8=False), sd)
        ms = [c["ms"] for c in calls]
        p50 = statistics.median(ms[1:])
        log(f"  means {means}; submap points cut by SUBMAP_POINTS a scan "
            f"{[int(c['submap_overflow']) for c in calls]}")
        log(f"  predict_step ms a scan {[round(x, 2) for x in ms]}; p50 after the first "
            f"{p50:.2f} ms; peak device memory {peak / 2**30:.2f} GiB [{card}]")
        want = {"zband_conv": routes(),
                "zband_conv_fused": routes(),
                "brick_conv_int8": 0, "brick_conv_int8_gather": 10 * n_scans}
        check_launches(dict(launches=launches), want, "9c predict")
        if twin_launches["brick_conv_int8_gather"] != 0:
            raise AssertionError("9c: the int8-off twin launched the int8 kernel")
        for i, c in enumerate(calls):
            s, v = c["scores"], c["valid"]
            if c["overflow"] or not np.isfinite(s).all() or not (s[v] > 0).all() or s.max() > 1:
                raise AssertionError(f"9c scan {i}: overflow, or scores not finite in (0, 1]")
        d = max(float(np.abs(a["scores"] - b["scores"])[a["valid"]].max())
                for a, b in zip(calls, twin_calls))
        log(f"  int8 against its int8-off twin: max |dscore| {d:.4e} (bound 0.1)")
        if not d <= 0.1:
            raise AssertionError(f"9c: int8 moves a score by {d} > 0.1 from its twin")
        blt_out = dict(ms=ms, p50=p50, peak=peak, launches=launches["brick_conv_int8_gather"],
                       int8_vs_twin=d, means=means)
        if profile:
            predict_profile(cfg, sd, card)

        log("phase 9d: replay of the same sequence, against the filter called directly")

        class SyncChecked(StreamingFilter):
            """The filter with every call under sync debug mode "error"."""

            def __call__(self, *args):
                torch.cuda.set_sync_debug_mode("error")
                try:
                    return super().__call__(*args)
                finally:
                    torch.cuda.set_sync_debug_mode("default")

        rp.StreamingFilter = SyncChecked
        try:
            torch.cuda.synchronize()
            reset_counts()
            stats = rp.replay_sequence(cfg, sd, BLT_SEQ, log=lambda m: log("  " + m))
            replay_launches = read_counts()["brick_conv_int8_gather"]
        finally:
            rp.StreamingFilter = StreamingFilter
        paths, poses = blt.sequence_files(root, BLT_SEQ)
        filt = StreamingFilter(cfg, sd, blt.load_map(root, cfg.data.map_file))
        ns = cfg.tpu.scan_points
        for i, path in enumerate(paths):
            scan = np.load(path)
            n = len(scan)
            sx = np.zeros((ns, 3), np.float32)
            sl = np.zeros(ns, np.float32)
            sv = np.zeros(ns, bool)
            sx[:n], sl[:n], sv[:n] = scan[:, :3], scan[:, 3], True
            scores, keep, _ = filt(sx, sv, sl, poses[i])
            if not (np.array_equal(stats.scores[i], scores[:n].float().cpu().numpy())
                    and np.array_equal(stats.keeps[i], keep[:n].cpu().numpy())):
                raise AssertionError(f"9d scan {i}: replay differs from the direct filter")
        summary = stats.summary()
        log(f"  replay: scores and keeps of {len(paths)} scans bit-equal to the direct filter; "
            f"every filter call ran in sync debug mode 'error'; brick_conv_int8_gather "
            f"launches {replay_launches} (expected {10 * n_scans}); summary {summary} [{card}]")
        if replay_launches != 10 * n_scans:
            raise AssertionError(f"9d: int8 launches {replay_launches}, expected {10 * n_scans}")
        del filt
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return blt_out, dict(summary=summary, launches=replay_launches)


# Phase 10: training. The train-step pin's tolerances (tests/test_torch_train_step.py's,
# f32 with TF32 off): loss and r2 rtol 1e-5; each gradient leaf within 1e-4 of its
# max |grad|; running statistics atol 1e-6 (1e-4 after 3 steps); each leaf's
# displacement from the initial weights within 1% (relative L2), every weight within
# 2 * sum(lr), and after one step weights whose effective gradient exceeds 1e-5
# within 1e-6.
PIN_LOSS_RTOL, PIN_GRAD_TOL = 1e-5, 1e-4
# The BLT-scale training data: phase 6's ten scans as config.yaml's splits.
TRAIN_SPLITS = {"20220420": range(0, 4), "20220601": range(4, 8), "20220608": range(8, 10)}
FIXED_BATCH_STEPS, FIXED_BATCH_LR = 8, 1e-3


def zband_grad_case(tag, c, route, seed):
    """zband_conv's autograd with the kernel forward against autograd through
    the plain version on f32 copies of the same operands, with the same
    cotangent: outputs, d_hz and d_wz, bf16 within 2e-2 of each reference's
    max-abs (one rounding of an f32 sum), f32 within 1e-4 of it.
    Returns (max error over the three, the kernel forward's ms, the plain
    backward's ms)."""
    import torch

    from sps_torch.ops import zband_conv as zc

    k, bs = c["k"], c["bs"]
    hz = c["hz"].clone().requires_grad_(True)
    wz = c["wz"].clone().requires_grad_(True)
    before = dict(zc.ROUTE_LAUNCHES["zband_conv"])
    out = zc.zband_conv(hz, wz, k, bs)
    taken = [r for r, n in zc.ROUTE_LAUNCHES["zband_conv"].items() if n != before[r]]
    if taken != [route]:
        raise AssertionError(f"10a {tag}: routes {taken}, expected {route}")
    g = torch.Generator(device="cuda").manual_seed(seed)
    dout = torch.randn(out.shape, generator=g, device="cuda").to(out.dtype)
    out.backward(dout)
    hz2 = c["hz"].float().requires_grad_(True)
    wz2 = c["wz"].float().requires_grad_(True)
    out2 = zc.zband_conv_ref(hz2, wz2, k, bs)
    out2.backward(dout.float())
    torch.cuda.synchronize()
    bar = 2e-2 if c["hz"].dtype == torch.bfloat16 else 1e-4
    worst = 0.0
    for what, a, b in (("out", out, out2), ("d_hz", hz.grad, hz2.grad),
                       ("d_wz", wz.grad, wz2.grad)):
        err = float((a.detach().float() - b.detach()).abs().max())
        scale = float(b.detach().abs().max())
        log(f"  zband_conv grad {tag:34s} {route:8s} {what:4s} max_abs_err {err:.3e} "
            f"(max-abs {scale:.3e}; bar {bar:g} x max-abs)")
        if not err <= bar * max(scale, 1e-6):
            raise AssertionError(f"10a {tag}: {what} of the kernel forward disagrees")
        worst = max(worst, err)
    fwd_ms = time_ms(lambda: zc.zband_conv(c["hz"], c["wz"], k, bs), runs=10, warmup=2)
    bwd_ms = time_ms(lambda: zc.zband_conv_bwd(c["hz"], c["wz"], dout, k, bs), runs=5,
                     warmup=1)
    return worst, fwd_ms, bwd_ms


def phase_train_kernels(card, bricks):
    """10a: the kernels under autograd, the halo backward card vs CPU, and
    zband_conv_fused refusing a gradient."""
    import torch

    from sps_torch.ops import atlas as atl
    from sps_torch.ops import brick as bk
    from sps_torch.ops import zband_conv as zc

    log("phase 10a: gradients of the kernels (zband_conv under autograd, halo backward)")
    reset_counts()
    b0 = bricks[0]
    cases = [  # (tag, make_case arguments, route)
        (f"stem k=5 B={b0} bf16", (5, 8, 2, 16, b0, torch.bfloat16), "wgmma_k5"),
        ("block8 k=3 B=2048 bf16", (3, 8, 32, 16, 2048, torch.bfloat16), "wgmma"),
        ("ragged k=3 bs=4 B=5 f32", (3, 4, 2, 3, 5, torch.float32), "wmma"),
    ]
    out = {}
    for i, (tag, args, route) in enumerate(cases):
        c = make_case(*args, seed=100 + i, with_res=False)
        err, fwd_ms, bwd_ms = zband_grad_case(tag, c, route, seed=200 + i)
        out[tag] = dict(route=route, max_abs_err=err, fwd_ms=fwd_ms, plain_bwd_ms=bwd_ms)
        log(f"  {tag}: kernel forward {fwd_ms:.3f} ms, plain backward (d_hz and d_wz) "
            f"{bwd_ms:.3f} ms [{card}]")
    # The halo backward: the gather-transpose on the card against the CPU, f32.
    rng = np.random.default_rng(0)
    n = 20000
    coords = torch.as_tensor(rng.integers(-60, 60, size=(n, 3)).astype(np.int32))
    grid, _ = atl.voxelize_bricks(coords, torch.zeros(n, dtype=torch.int32),
                                  torch.as_tensor(rng.integers(0, 2, n).astype(np.int32)),
                                  torch.ones(n, dtype=torch.bool), num_time=2,
                                  brick_capacity=4096, brick_side=8, extent=(1, 16, 16, 16))
    lv = atl.build_levels(grid, num_levels=1, capacities=(4096,))[0]
    nb = int(grid.num_bricks)
    if not 0 < nb < lv.nbr27.shape[1] or bool(grid.overflow):
        raise AssertionError("10a: the halo test grid overflowed")
    for pad in (1, 2):
        for folded in (False, True):
            x = torch.as_tensor(rng.normal(size=(lv.nbr27.shape[1], 8, 8, 8, 4)).astype(np.float32))
            x[nb:] = 0
            if folded:
                x = x.reshape(x.shape[0], 8, 8, 32)
            grads = []
            for dev in ("cpu", "cuda"):
                xt = x.to(dev).detach().clone().requires_grad_(True)
                nbr = lv.nbr27.to(dev)
                y = bk.halo_z(xt, nbr, pad, 4) if folded else bk.halo(xt, nbr, pad)
                if type(y.grad_fn).__name__ != "_SymmetricHaloBackward":
                    raise AssertionError("10a: halo took autograd's scatter, not its transpose")
                gy = torch.as_tensor(np.random.default_rng(pad).normal(size=y.shape)
                                     .astype(np.float32)).to(dev)
                y.backward(gy)
                grads.append(xt.grad.cpu())
            err = float((grads[0] - grads[1]).abs().max())
            log(f"  halo{'_z' if folded else ''} backward pad {pad}, {nb} bricks: card vs CPU "
                f"max_abs_err {err:.3e} (bar 1e-6)")
            if not err <= 1e-6:
                raise AssertionError("10a: the halo backward differs between card and CPU")
    c = make_case(3, 4, 2, 2, 4, torch.float32, seed=9)
    hz = c["hz"].clone().requires_grad_(True)
    try:
        zc.zband_conv_fused(hz, c["wz"], c["scale"], c["bias"], c["occ"], c["res"], k=3, bs=4)
    except RuntimeError as e:
        log(f"  zband_conv_fused under a gradient raises: {e}")
    else:
        raise AssertionError("10a: zband_conv_fused ran with a gradient required")
    counts = read_counts()
    log(f"  launches in 10a: {counts}")
    if counts["zband_conv_fused"] != dict.fromkeys(zc.ROUTES, 0):
        raise AssertionError("10a: zband_conv_fused launched")
    return out


def pin_tree(z, prefix):
    out: dict = {}
    for k in z.files:
        if k.startswith(prefix + "/"):
            *parents, leaf = k[len(prefix) + 1:].split("/")
            node = out
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[k]
    return out


def pin_flat(z, prefix):
    return {k[len(prefix) + 1:].replace("/", "."): z[k] for k in z.files
            if k.startswith(prefix + "/")}


def pin_config(meta, record):
    """config_small.yaml with the pin's overrides and narrow widths."""
    from sps_torch import config

    def tuples(d):
        return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}

    tpu, hp, _ = meta["records"][record]
    cfg = config.load(os.path.join(HERE, "config", "config_small.yaml"))
    cfg = dataclasses.replace(
        cfg, voxel_size=meta["voxel_size"],
        tpu=dataclasses.replace(cfg.tpu, **tuples({**meta["tpu"], **tpu})),
        train=dataclasses.replace(cfg.train, **tuples({**meta["train"], **hp})))
    narrow = tuples(meta["narrow"])

    class Narrow(type(cfg)):
        def sps_config(self, batch_size=None):
            s = super().sps_config(batch_size)
            return dataclasses.replace(s, unet=dataclasses.replace(s.unet, **narrow))

    return Narrow(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def check_pin_params(sd, init, want, grads, lr_sum, first_step, tag):
    worst = 0.0
    for name, w in want.items():
        got, w0 = sd[name].cpu().numpy(), init[name].numpy()
        moved = w - w0
        rel = float(np.linalg.norm((got - w0) - moved) / max(np.linalg.norm(moved), 1e-30))
        worst = max(worst, rel)
        if rel > 1e-2 or np.abs(got - w).max() > 2 * lr_sum:
            raise AssertionError(f"10b {tag}: {name} moved differently ({rel:.3e})")
        if first_step:
            big = np.abs(grads[name] + 1e-4 * w0) >= 1e-5
            if big.any() and np.abs(got[big] - w[big]).max() > 1e-6:
                raise AssertionError(f"10b {tag}: {name} differs where Adam is well posed")
    return worst


def phase_train_pin(card):
    """10b: sps_tpu's pinned training step (train_step_pin.npz) on the card
    in f32: loss, gradients, running statistics, weights after 1 and 3 Adam
    steps, for each of the pin's records."""
    import torch

    from sps_torch import train
    from sps_torch.convert import state_dict_from_jax
    from sps_torch.ops import zband_conv as zc

    log("phase 10b: the train-step pin on the card (f32, TF32 off)")
    z = np.load(os.path.join(HERE, "sps_torch", "assets", "train_step_pin.npz"))
    meta = json.loads(str(z["meta"]))
    batch = {k: torch.as_tensor(z[f"batch/{k}"], device="cuda") for k in ("xyz", "label", "valid")}
    mp = torch.as_tensor(z["map"], device="cuda")
    out = {}
    for record, (_, _, steps) in meta["records"].items():
        cfg = pin_config(meta, record)
        state = train.create_state(cfg, 0, steps_per_epoch=1, device="cuda")
        init = state_dict_from_jax(pin_tree(z, f"{record}/init"))
        state.model.load_state_dict(init, strict=True)
        reset_counts()
        lrs = []
        for i in range(steps):
            lrs.append(state.optimizer.param_groups[0]["lr"])
            m = train.train_step(state, batch, mp, cfg=cfg, augment=False)
            if i > 0:
                continue
            loss, r2 = float(m["loss"]), float(m["r2"])
            grads = pin_flat(z, f"{record}/grads")
            gerr = max(float(np.abs(p.grad.cpu().numpy() - grads[n]).max())
                       / max(float(np.abs(grads[n]).max()), 1e-12)
                       for n, p in state.model.named_parameters())
            sd = {k: v.clone() for k, v in state.model.state_dict().items()}
            serr = max(float(np.abs(sd[n].cpu().numpy() - w).max())
                       for n, w in pin_flat(z, f"{record}/batch_stats_1").items())
            prel = check_pin_params(sd, init, pin_flat(z, f"{record}/params_1"), grads,
                                    lrs[0], True, record)
            log(f"  {record}: loss {loss:.7f} (pin {float(z[f'{record}/loss']):.7f}), r2 "
                f"{r2:.6f} (pin {float(z[f'{record}/r2']):.6f}), gradients within "
                f"{gerr:.2e} of each leaf's max, running statistics within {serr:.2e}, "
                f"step-1 displacement within {prel:.2e}")
            if (abs(loss - float(z[f"{record}/loss"])) > PIN_LOSS_RTOL * abs(float(z[f"{record}/loss"]))
                    or abs(r2 - float(z[f"{record}/r2"])) > PIN_LOSS_RTOL * abs(float(z[f"{record}/r2"]))
                    or gerr > PIN_GRAD_TOL or serr > 1e-6 or bool(m["overflow"])):
                raise AssertionError(f"10b {record}: the card's step differs from the pin")
            out[record] = dict(loss=loss, grad_rel_err=gerr, stats_err=serr, step1_rel=prel)
        if steps > 1:
            sd = state.model.state_dict()
            prel = check_pin_params(sd, init, pin_flat(z, f"{record}/params_{steps}"), grads,
                                    sum(lrs), False, record)
            serr = max(float(np.abs(sd[n].cpu().numpy() - w).max())
                       for n, w in pin_flat(z, f"{record}/batch_stats_{steps}").items())
            log(f"  {record}: after {steps} steps displacement within {prel:.2e}, running "
                f"statistics within {serr:.2e} (bar 1e-4)")
            if serr > 1e-4:
                raise AssertionError(f"10b {record}: running statistics after {steps} steps")
            out[record].update(steps_rel=prel)
        launches = read_counts()
        want_k = steps if cfg.tpu.stem_zband else 0
        # The route the f32 stem takes by zband_conv.route's rule: at the
        # pin's narrow widths (N = 64) the WMMA kernel.
        stems = [key for key in zc.SHAPE_LAUNCHES if key[0] == "zband_conv"]
        stem_route = "wmma"
        if stems:
            _, _, hz_shape, wz_shape = stems[0]
            stem_route = zc.route(torch.empty(hz_shape, device="cuda"),
                                  torch.empty(wz_shape, device="cuda"), wz_shape[0],
                                  hz_shape[1] - wz_shape[0] + 1)
            log(f"  {record}: the stem hz{hz_shape} wz{wz_shape} takes route {stem_route}")
        if len(stems) > 1 or launches["zband_conv"][stem_route] != want_k or any(
                v for name, r in launches.items() if isinstance(r, dict)
                for route, v in r.items() if (name, route) != ("zband_conv", stem_route)):
            raise AssertionError(f"10b {record}: launches {launches}")
        out[record]["launches"] = launches["zband_conv"]
        del state
    torch.cuda.empty_cache()
    return out


def timed_train_step(train):
    """train.train_step wrapped to record each call: its synchronised ms,
    the hand-written kernels launched in it, and its metrics."""
    import torch

    real, calls = train.train_step, []

    def wrapper(state, batch, map_points, rng=None, map_vm=None, *, cfg, augment):
        before = read_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = real(state, batch, map_points, rng, map_vm, cfg=cfg, augment=augment)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        after = read_counts()
        launches = {}
        for k, v in after.items():
            launches[k] = ({r: v[r] - before[k][r] for r in v} if isinstance(v, dict)
                           else v - before[k])
        calls.append(dict(ms=ms, launches=launches, **{k: float(v) for k, v in m.items()}))
        return m

    return real, wrapper, calls


def write_train_data(stable, data):
    root = os.path.join(HERE, "build", "train_blt")
    shutil.rmtree(root, ignore_errors=True)
    scans, valids, labels = data
    for seq, idx in TRAIN_SPLITS.items():
        idx = list(idx)
        write_blt(root, seq, stable, (scans[idx], valids[idx], labels[idx]))
    return root


def fit_run(cfg, label, card, **kw):
    """train.fit with every step recorded and the launch counts set to 0 just
    before and read just after; prints the steps and returns the records."""
    import torch

    from sps_torch import train

    real, wrapper, calls = timed_train_step(train)
    train.train_step = wrapper
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t = time.perf_counter()
        path = train.fit(cfg, device="cuda", **kw)
        wall = time.perf_counter() - t
        launches = read_counts()
    finally:
        train.train_step = real
    peak = torch.cuda.max_memory_allocated()
    for i, c in enumerate(calls):
        log(f"  {label} step {i + 1}: {c['ms']:.1f} ms, loss {c['loss']:.5f}, r2 {c['r2']:.4f}, "
            f"overflow {bool(c['overflow'])}, submap_overflow {int(c['submap_overflow'])}")
        if not (np.isfinite(c["loss"]) and np.isfinite(c["r2"])) or c["overflow"]:
            raise AssertionError(f"{label} step {i + 1}: loss not finite or overflow")
    ms = [c["ms"] for c in calls]
    p50 = statistics.median(ms[1:]) if len(ms) > 1 else ms[0]
    log(f"  {label}: {len(calls)} steps, step p50 after the first {p50:.1f} ms, peak device "
        f"memory {peak / 2**30:.2f} GiB, fit wall {wall:.1f} s; launches in the run "
        f"{launches} [{card}]")
    return dict(path=path, calls=calls, p50=p50, peak=peak, launches=launches)


def profile_train_steps(state, batch, mp, cfg, card, label, n=2):
    from sps_torch import train

    kernels, _, wall_us = profiled(
        lambda i: train.train_step(state, batch, mp, cfg=cfg, augment=False), n)
    busy = sum(_device_us(e) for e in kernels)
    launches = sum(e.count for e in kernels)
    log(f"  profile ({label}): {n} steps, wall {wall_us / 1e3:.1f} ms, kernels "
        f"{busy / n / 1e3:.2f} ms a step (device busy {100 * busy / wall_us:.1f}%), "
        f"{launches / n:.0f} CUDA kernel launches a step [{card}]")
    for e in sorted(kernels, key=_device_us, reverse=True)[:12]:
        log(f"  kernel {_device_us(e) / n / 1e3:9.3f} ms a step x{e.count // n:5d}  {e.key[:90]}")
    return dict(kernel_ms=busy / n / 1e3, launches=launches / n, busy=busy / wall_us)


def no_train_launches(calls, label):
    """The inference-only kernels never launch in a training step."""
    for i, c in enumerate(calls):
        fused = sum(c["launches"]["zband_conv_fused"].values())
        int8 = c["launches"]["brick_conv_int8"] + c["launches"]["brick_conv_int8_gather"]
        if fused or int8:
            raise AssertionError(f"{label} step {i + 1}: zband_conv_fused {fused} / int8 {int8} "
                                 "launches in a training step")


def phase_train(card, shipped, stable, data):
    """10c: train.fit at config/config.yaml as shipped (MinkUNet14 full width,
    atlas, halo, bf16, batch 2, augmentation on) on phase 6's scans written to
    disk as config.yaml's splits: an epoch (4 steps) and a validation, a
    resume for one more step, predict_sequence from `best`; a profile of two
    steps; then FIXED_BATCH_STEPS steps on one batch without augmentation,
    whose loss must fall."""
    import torch

    from sps_torch import eval as ev
    from sps_torch import train
    from sps_torch.convert import load_weights
    from sps_torch.utils import checkpoint as ckpt

    log("phase 10c: training at config.yaml as shipped (fit, resume, predict from best)")
    root = write_train_data(stable, data)
    out_dir = os.path.join(HERE, "build", "train_run")
    shutil.rmtree(out_dir, ignore_errors=True)
    base = dataclasses.replace(shipped, data=dataclasses.replace(shipped.data, root=root))
    kw = dict(log_dir=os.path.join(out_dir, "logs"), ckpt_dir=os.path.join(out_dir, "ckpt"))
    try:
        cfg1 = dataclasses.replace(base, train=dataclasses.replace(base.train, max_epoch=1))
        log(f"  batch {cfg1.train.batch_size}, bricks {cfg1.sps_config().caps.bricks}, "
            f"planes {cfg1.sps_config().unet.planes}, dtype {cfg1.sps_config().unet.dtype}, "
            f"augmentation {cfg1.train.augmentation}, LR {cfg1.train.lr}")
        run = fit_run(cfg1, "fit", card, **kw)
        no_train_launches(run["calls"], "10c")
        best = run["path"]
        last = ckpt.restore(os.path.join(kw["ckpt_dir"], "last.pt"))
        if not (os.path.isfile(best) and last["step"] == 4 and last["epoch"] == 0
                and np.isfinite(last["best_val"])):
            raise AssertionError(f"10c: checkpoints after the epoch: step {last['step']}, "
                                 f"epoch {last['epoch']}, best_val {last['best_val']}")
        val_int8 = run["launches"]["brick_conv_int8_gather"]
        log(f"  best {best} (val loss {last['best_val']:.5f}); the validation's int8 gather "
            f"launches {val_int8} (eval mode; none in the training steps)")
        cfg2 = dataclasses.replace(base, train=dataclasses.replace(base.train, max_epoch=2))
        resumed = fit_run(cfg2, "resume", card, max_steps=5, resume=True, **kw)
        no_train_launches(resumed["calls"], "10c resume")
        last = ckpt.restore(os.path.join(kw["ckpt_dir"], "last.pt"))
        if len(resumed["calls"]) != 1 or last["step"] != 5 or not last["mid_epoch"]:
            raise AssertionError("10c: the resume did not take exactly one step")
        cfg_p = dataclasses.replace(base, data=dataclasses.replace(base.data,
                                                                   test=("20220608",)))
        means = ev.predict_sequence(cfg_p, load_weights(best, cfg_p.sps_config(1)))
        if not all(np.isfinite(means[k]) for k in ev.METRICS):
            raise AssertionError(f"10c: predict from best: {means}")
        # Profile two steps, then a fixed batch without augmentation.
        cfg_f = dataclasses.replace(base, train=dataclasses.replace(
            base.train, augmentation=False, lr=FIXED_BATCH_LR))
        state = train.create_state(cfg_f, 0, steps_per_epoch=4, device="cuda")
        scans, valids, labels = data
        batch = {"xyz": torch.as_tensor(scans[:2], device="cuda"),
                 "label": torch.as_tensor(labels[:2], device="cuda"),
                 "valid": torch.as_tensor(valids[:2], device="cuda")}
        mp = torch.as_tensor(stable, device="cuda")
        prof = profile_train_steps(state, batch, mp, cfg_f, card, "train step, config.yaml")
        state = train.create_state(cfg_f, 0, steps_per_epoch=4, device="cuda")
        losses = [float(train.train_step(state, batch, mp, cfg=cfg_f, augment=False)["loss"])
                  for _ in range(FIXED_BATCH_STEPS)]
        log(f"  fixed batch, augmentation off, LR {FIXED_BATCH_LR}: losses "
            f"{[round(x, 5) for x in losses]}")
        if not losses[-1] < losses[0]:
            raise AssertionError("10c: the loss does not fall on a fixed batch")
        del state
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return dict(fit=run, resume=resumed, predict=means, profile=prof, fixed_losses=losses,
                root=root)


def stem_times(filt, sd, card):
    """The stem of the last rebuild (batch 1, B = the L0 brick capacity):
    bf16 halo() + cuDNN conv3d (the shipping stem) against halo_z + the
    zband_conv kernel (STEM_ZBAND), each whole and its conv alone."""
    import torch

    from sps_torch.ops import brick as bk
    from sps_torch.ops import zband_conv as zc

    lv = filt._topo_cache[0][0]
    occ = lv.grid.occ
    feats = (0.5 * occ).to(torch.bfloat16)
    w = sd["MinkUNet.conv0p1s1.kernel"].to("cuda", torch.bfloat16)
    wd = bk.pack_dense_kernel(w, 2)
    occz = occ.reshape(occ.shape[0], 8, 8, -1)
    h = bk.halo(feats, lv.nbr27, 2)
    hz = bk.halo_z(bk.fold_z(feats), lv.nbr27, 2, 2)
    wz = bk.pack_zband_kernel(wd, 8, 2)
    with torch.inference_mode():
        t = dict(
            halo_conv3d=time_ms(lambda: bk.brick_conv(feats, lv.nbr27, wd, occ, mask_out=False)),
            conv3d=time_ms(lambda: bk._conv3d_valid(h, wd)),
            halo_z_kernel=time_ms(lambda: bk.brick_conv_zband(bk.fold_z(feats), lv.nbr27, wd,
                                                              occz, mask_out=False)),
            kernel=time_ms(lambda: zc.zband_conv(hz, wz, 5, 8)))
    log(f"  stem at B = {occ.shape[0]} (bf16): halo() + cuDNN conv3d {t['halo_conv3d']:.3f} ms "
        f"(conv3d alone {t['conv3d']:.3f}); halo_z + wgmma_k5 {t['halo_z_kernel']:.3f} ms "
        f"(kernel alone {t['kernel']:.3f}) [{card}]")
    return t


def filter_kernel_ms(filt, data, card, label, n=8):
    """Kernel time and launches a scan of the filter over n scans, those of
    the z-band kernels apart (profiler; after a warm-up scan, from a fresh
    rebuild): {kernel_ms, launches, zband_kernel_ms}."""
    scans, valids, labels = data
    pose = np.eye(4, dtype=np.float32)
    filt(scans[0], valids[0], labels[0], pose)
    filt.invalidate()
    kernels, _, _ = profiled(lambda i: filt(scans[i], valids[i], labels[i], pose), n)
    zband = [e for e in kernels if "zband" in e.key]
    out = dict(kernel_ms=sum(_device_us(e) for e in kernels) / n / 1e3,
               launches=sum(e.count for e in kernels) / n,
               zband_kernel_ms=sum(_device_us(e) for e in zband) / n / 1e3)
    log(f"  {label} filter: kernels {out['kernel_ms']:.2f} ms a scan, {out['launches']:.0f} "
        f"launches a scan; z-band kernels {out['zband_kernel_ms']:.3f} ms, "
        f"{sum(e.count for e in zband) / n:.0f} launches a scan ({n} scans) [{card}]")
    return out


def phase_train_stem_zband(card, shipped, sd, stable, data, ship_run, root):
    """10d: STEM_ZBAND. Three training steps at config.yaml + STEM_ZBAND (one
    wgmma_k5 launch a step), then the streaming filter at config.yaml +
    STEM_ZBAND on phase 6's scans: one wgmma_k5 launch a scan, scores within
    0.05 of the halo stem's (phase 6's run), the stem's times, and the kernel
    time a scan of both filters (profiler, 8 scans)."""
    import torch

    from sps_torch.stream.engine import StreamingFilter

    log("phase 10d: STEM_ZBAND (training and the streaming filter)")
    out_dir = os.path.join(HERE, "build", "train_run_sz")
    shutil.rmtree(out_dir, ignore_errors=True)
    cfg = twin(dataclasses.replace(shipped, data=dataclasses.replace(shipped.data, root=root)),
               stem_zband=True)
    try:
        run = fit_run(cfg, "fit STEM_ZBAND", card, max_steps=3,
                      log_dir=os.path.join(out_dir, "logs"), ckpt_dir=os.path.join(out_dir, "ckpt"))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    no_train_launches(run["calls"], "10d")
    for i, c in enumerate(run["calls"]):
        if c["launches"]["zband_conv"] != routes(wgmma_k5=1):
            raise AssertionError(f"10d step {i + 1}: zband_conv launches {c['launches']}")
    torch.cuda.empty_cache()
    scfg = twin(shipped, stem_zband=True)
    filt, frun = drive(scfg, sd, stable, data)
    n_scans = len(data[0])
    frun["p50"] = check_run(frun, data[1], scfg.tpu.topo_every, card, "STEM_ZBAND filter")
    check_launches(frun, {"zband_conv": routes(wgmma_k5=n_scans),
                          "zband_conv_fused": routes(),
                          "brick_conv_int8": 0, "brick_conv_int8_gather": 10 * n_scans},
                   "STEM_ZBAND filter")
    frun["vs_halo_stem"] = compare_runs(frun, ship_run, data[1], shipped.threshold, 0.05,
                                        "STEM_ZBAND filter vs the halo stem (phase 6)")
    stem = stem_times(filt, sd, card)
    per_scan = {"STEM_ZBAND": filter_kernel_ms(filt, data, card, "STEM_ZBAND")["kernel_ms"]}
    del filt
    torch.cuda.empty_cache()
    filt = StreamingFilter(shipped, sd, stable)
    per_scan["halo stem"] = filter_kernel_ms(filt, data, card, "halo stem")["kernel_ms"]
    del filt
    torch.cuda.empty_cache()
    return dict(fit=run, filter=dict(p50=frun["p50"], peak=frun["peak"],
                                     launches=frun["launches"],
                                     vs_halo_stem=frun["vs_halo_stem"]),
                stem_ms=stem, kernels_ms_a_scan=per_scan)


# Phase 12: the hash engines. sps_tpu's pin of 12a (scripts/export_torch_assets.py
# --only hash); the f32 tolerance of every score comparison in 12a and 12b
# (the CPU tests' against sps_tpu); the steps of 12a's fit and fixed batch;
# 12b's scans; the int8 kernel's launches a scan on the brick engine (16 3^3
# convs on five brick levels, block5_0.conv1's C = 192 in six launches of 32
# channels: ops/brick.py INT8_CHUNK).
HASH_PIN = os.path.join(HERE, "sps_torch", "assets", "hash_engines_pin.npz")
HASH_RTOL, HASH_ATOL = 1e-3, 1e-4
HASH_FIT_STEPS, HASH_FIXED_STEPS = 4, 6
ENGINE_PARITY_SCANS = 3
BRICK_INT8_LAUNCHES = 21


def hash_world(meta, ns):
    """The hash pin's world (phase 3's, sps_torch.data.synthetic): the map
    and the scans padded to ns, with their valid masks and labels."""
    from sps_torch.data import synthetic

    stable = synthetic.make_world(**meta["world"])
    rng = np.random.default_rng(meta["rng_seed"])
    clutter = synthetic._boxes(rng, *meta["clutter"]).astype(np.float32)
    scans = np.zeros((meta["scans"], ns, 3), np.float32)
    valids = np.zeros((meta["scans"], ns), bool)
    labels = np.zeros((meta["scans"], ns), np.float32)
    for i in range(meta["scans"]):
        pts, lab = synthetic.sample_scan(rng, stable, clutter, np.array([meta["step"] * i, 0.0]),
                                         n_rays=meta["n_rays"])
        k = min(len(pts), ns)
        scans[i, :k], valids[i, :k], labels[i, :k] = pts[:k], True, lab[:k]
    return stable, scans, valids, labels


def equal(what, got, want):
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or not np.array_equal(got, want):
        bad = int((got != want).sum()) if got.shape == want.shape else "shape"
        raise AssertionError(f"{what}: not bit-equal ({bad} entries differ)")


def hash_syncs(fn):
    """fn()'s result and the host syncs the hash probe loops took in it."""
    from sps_torch.ops import hash as vhash

    vhash.reset_syncs()
    out = fn()
    return out, vhash.SYNCS["hash"]


def phase_hash_small(card):
    """12a: config/config_small.yaml as shipped (ENGINE gather, JOIN_MODE hash,
    f32, TF32 off), MinkUNet14 at full width with phase 3's seeded weights on
    phase 3's world: the first scan's voxelize table and point2voxel and the
    hash join's mask on the card, on the CPU and in sps_tpu's pin, bit-equal;
    assemble_batch card vs CPU; StreamingFilter card vs CPU and vs the pin;
    then fit, predict_sequence, replay_sequence and run_localization on the
    world written to disk, and a fixed batch whose loss must fall."""
    import torch

    from sps_torch import config, pipeline, train
    from sps_torch import eval as ev
    from sps_torch.convert import load_weights
    from sps_torch.data import synthetic
    from sps_torch.models import spsnet
    from sps_torch.ops import radius as rad
    from sps_torch.ops import voxelize as vox
    from sps_torch.stream.engine import StreamingFilter
    from sps_torch.stream.localize import run_localization
    from sps_torch.stream.replay import replay_sequence

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("phase 12a: config_small.yaml as shipped (gather engine, hash join), f32, full width")
    pin = np.load(HASH_PIN)
    meta = json.loads(str(pin["meta"]))
    cfg = config.load(os.path.join(HERE, meta["config"]))
    if not (cfg.tpu.engine == "gather" and cfg.tpu.join_mode == "hash" and not cfg.tpu.bf16):
        raise AssertionError("config_small.yaml is not the gather engine with the hash join")
    scfg = cfg.sps_config(1)
    stable, scans, valids, labels = hash_world(meta, cfg.tpu.scan_points)
    sd = spsnet.init_state_dict(scfg, seed=meta["weights_seed"])
    n, vcap = scans.shape[1], scfg.caps.voxels[0]

    def first_scan(dev):
        x = torch.as_tensor(scans[0], device=dev)
        v = torch.as_tensor(valids[0], device=dev)
        mp = torch.as_tensor(stable, device=dev)
        zeros = torch.zeros(n, dtype=torch.int32, device=dev)
        grid, p2v, _ = vox.voxelize(vox.quantize(x, cfg.voxel_size), zeros, zeros + 1, v,
                                    num_time=2, voxel_capacity=vcap)
        mask, dropped = rad.radius_join(x, v, mp, torch.ones(len(stable), dtype=torch.bool,
                                                              device=dev),
                                        cfg.voxel_size, cell_capacity=cfg.tpu.cell_capacity,
                                        max_per_cell=cfg.tpu.max_per_cell)
        return {"voxel/keys": grid.table.keys, "voxel/rows": grid.table.rows,
                "voxel/p2v": p2v, "voxel/num_voxels": grid.num_voxels, "join/mask": mask,
                "join/dropped": dropped}

    (on_card, syncs), on_cpu = hash_syncs(lambda: first_scan("cuda")), first_scan("cpu")
    for key, want in on_card.items():
        equal(f"12a {key} card vs sps_tpu's pin", want.cpu().numpy(), pin[key])
        equal(f"12a {key} CPU vs sps_tpu's pin", on_cpu[key].numpy(), pin[key])
    log(f"  first scan: {int(pin['voxel/num_voxels'])} voxels, table keys/rows and point2voxel "
        f"bit-equal to the pin on the card and the CPU; the join keeps "
        f"{int(pin['join/mask'].sum())} of {len(stable)} map points (dropped "
        f"{int(pin['join/dropped'])}), bit-equal; {syncs} host syncs in the card's voxelize "
        f"and join")

    def assemble(dev):
        t = [torch.as_tensor(a, device=dev) for a in (scans, labels, valids, stable)]
        return pipeline.assemble_batch(*t, cfg)

    (pb_g, aux_g), (pb_c, aux_c) = assemble("cuda"), assemble("cpu")
    for name in ("xyz", "batch", "t", "label", "valid"):
        equal(f"12a assemble_batch {name} card vs CPU", getattr(pb_g, name).cpu().numpy(),
              getattr(pb_c, name).numpy())
    for name in aux_c:
        if int(aux_g[name]) != int(aux_c[name]):
            raise AssertionError(f"12a assemble_batch {name}: card {int(aux_g[name])}, "
                                 f"CPU {int(aux_c[name])}")
    log(f"  assemble_batch (batch 2, hash join) bit-equal card vs CPU: submap_count "
        f"{int(aux_g['submap_count'])}, cell_dropped {int(aux_g['cell_dropped'])}, "
        f"submap_overflow {int(aux_g['submap_overflow'])}")

    f_gpu = StreamingFilter(cfg, sd, stable)
    f_cpu = StreamingFilter(cfg, sd, stable, device="cpu")
    pose = np.eye(4, dtype=np.float32)
    worst = 0.0
    for i in range(len(scans)):
        (out_g, syncs), out_c = (hash_syncs(lambda: f_gpu(scans[i], valids[i], labels[i], pose)),
                                 f_cpu(scans[i], valids[i], labels[i], pose))
        s_g = out_g[0].cpu()
        torch.testing.assert_close(s_g, out_c[0], rtol=HASH_RTOL, atol=HASH_ATOL)
        torch.testing.assert_close(s_g, torch.as_tensor(pin["scores"][i]), rtol=HASH_RTOL,
                                   atol=HASH_ATOL)
        for key in ("n_scan_voxels", "n_submap_voxels", "n_kept"):
            if not int(out_g[2][key]) == int(out_c[2][key]) == int(pin[f"stats/{key}"][i]):
                raise AssertionError(f"12a filter scan {i}: {key} card {int(out_g[2][key])}, "
                                     f"CPU {int(out_c[2][key])}, pin {pin[f'stats/{key}'][i]}")
        if bool(out_g[2]["overflow"]) or "topo_miss_points" in out_g[2]:
            raise AssertionError(f"12a filter scan {i}: overflow, or the atlas engine's stats")
        d = float((s_g - torch.as_tensor(pin["scores"][i])).abs().max())
        worst = max(worst, d)
        log(f"  filter scan {i}: max |score_card - score_cpu| "
            f"{float((s_g - out_c[0]).abs().max()):.3e}, against sps_tpu's pin {d:.3e}; "
            f"n_scan_voxels {int(out_g[2]['n_scan_voxels'])}, n_submap_voxels "
            f"{int(out_g[2]['n_submap_voxels'])}; {syncs} host syncs")
    del f_gpu, f_cpu

    root = os.path.join(HERE, "build", "hash_small")
    out_dir = os.path.join(HERE, "build", "hash_small_run")
    for d in (root, out_dir):
        shutil.rmtree(d, ignore_errors=True)
    try:
        synthetic.generate(root, scans_per_seq=3, seed=meta["world"]["seed"],
                           extent=meta["world"]["extent"], n_rays=meta["n_rays"],
                           ground_points=meta["world"]["ground_points"],
                           n_stable=meta["world"]["n_stable"])
        base = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, root=root))
        kw = dict(log_dir=os.path.join(out_dir, "logs"), ckpt_dir=os.path.join(out_dir, "ckpt"))
        run = fit_run(base, "12a fit", card, max_steps=HASH_FIT_STEPS, **kw)
        if len(run["calls"]) != HASH_FIT_STEPS:
            raise AssertionError(f"12a fit: {len(run['calls'])} steps")
        means = ev.predict_sequence(base, load_weights(run["path"], base.sps_config(1)))
        if not all(np.isfinite(means[k]) for k in ev.METRICS):
            raise AssertionError(f"12a predict_sequence: {means}")
        rs = replay_sequence(base, sd, "20220629", log=lambda *a: None)
        loc = run_localization(base, sd, "20220629", "sps", prior="odom", log=lambda *a: None)
        if not (len(rs.rows) == 3 and np.isfinite(loc["ate_rmse"]) and loc["ate_rmse"] < 0.5):
            raise AssertionError(f"12a replay {len(rs.rows)} scans, localization ATE "
                                 f"{loc['ate_rmse']}")
        log(f"  predict_sequence from the fit's checkpoint: "
            + ", ".join(f"{k} {means[k]:.4f}" for k in ev.METRICS)
            + f"; replay_sequence {len(rs.rows)} scans; run_localization (sps, prior odom) ATE "
            f"{loc['ate_rmse']:.4f} m")
        cfg_f = dataclasses.replace(base, train=dataclasses.replace(base.train,
                                                                    augmentation=False))
        state = train.create_state(cfg_f, 0, steps_per_epoch=4, device="cuda")
        batch = {"xyz": torch.as_tensor(scans, device="cuda"),
                 "label": torch.as_tensor(labels, device="cuda"),
                 "valid": torch.as_tensor(valids, device="cuda")}
        mp = torch.as_tensor(stable, device="cuda")
        losses = [float(train.train_step(state, batch, mp, cfg=cfg_f, augment=False)["loss"])
                  for _ in range(HASH_FIXED_STEPS)]
        log(f"  fixed batch, augmentation off, LR {cfg_f.train.lr}: losses "
            f"{[round(x, 5) for x in losses]}")
        if not losses[-1] < losses[0]:
            raise AssertionError("12a: the loss does not fall on a fixed batch")
        del state
    finally:
        for d in (root, out_dir):
            shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()
    return dict(pin_max_dscore=worst, fit_p50=run["p50"], losses=losses,
                predict=means, ate=loc["ate_rmse"])


def hash_run_checks(run, label):
    """Phase 4's checks for a hash engine's run (no topology reuse)."""
    for i, (s, st) in enumerate(zip(run["scores"], run["stats"])):
        if bool(st["overflow"]):
            raise AssertionError(f"{label} scan {i}: capacity overflow")
        if not np.isfinite(s).all() or s.min() < 0 or s.max() > 1:
            raise AssertionError(f"{label} scan {i}: scores not finite or outside [0, 1]")
    return statistics.median(run["lat"])


def gather_twin(cfg, data):
    """The gather engine at cfg. Where the scans hold more voxels at a level
    than config.yaml's VOXELS give a scan (the quarter-metre and coarser
    levels of a BLT scan do), that level's capacity is raised to 1.25 times
    the most voxels any scan has there, in steps of 1024, and logged."""
    scans, valids, _ = data
    g = twin(cfg, engine="gather")
    have = g.sps_config(1).caps.voxels
    need = [0] * len(have)
    for x, v in zip(scans, valids):
        c = np.floor(x[v] / cfg.voxel_size).astype(np.int64)
        for li in range(len(have)):
            need[li] = max(need[li], len(np.unique(c >> li, axis=0)))
    caps = [max(h, -(-int(1.25 * n) // 1024) * 1024) for h, n in zip(have, need)]
    if caps != list(have):
        log(f"  gather engine: voxels a level in the scans {need}; capacities a scan raised "
            f"from {list(have)} to {caps} (VOXELS {[2 * c for c in caps]} at BATCH_SIZE 2)")
        g = twin(g, voxels=tuple(2 * c for c in caps))
    return g


def phase_engines_parity(card, shipped, sd, stable, data):
    """12b: the gather engine, the brick engine (side 8, region) and the atlas
    engine (halo) on phase 6's first scans, f32, TF32 off, the rebuild
    program, seeded full-width weights: none overflows, and each hash
    engine's scores are within rtol 1e-3 / atol 1e-4 of the atlas engine's
    (tests/test_minkunet.py's cross-engine claim for sps_tpu)."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("phase 12b: cross-engine parity at BLT scale (f32, rebuild program, full width)")
    sub = tuple(a[:ENGINE_PARITY_SCANS] for a in data)
    base = twin(shipped, int8=False, bf16=False, topo_every=0)
    gather = gather_twin(base, data)
    cfgs = {"atlas (halo)": base, "brick (side 8, region)": twin(base, engine="brick",
                                                                  conv_mode="region"),
            "gather": gather}
    runs = {}
    for name, cfg in cfgs.items():
        (filt, run), syncs = hash_syncs(lambda: drive(cfg, sd, stable, sub))
        p50 = hash_run_checks(run, f"12b {name}")
        check_launches(run, {"zband_conv": routes(),
                             "zband_conv_fused": routes(),
                             "brick_conv_int8": 0, "brick_conv_int8_gather": 0}, f"12b {name}")
        log(f"  {name}: p50 {p50:.2f} ms (f32), {syncs / len(sub[0]):.1f} host syncs a scan, "
            f"n_scan_voxels {[int(st['n_scan_voxels']) for st in run['stats']]}")
        runs[name] = run
        del filt
        torch.cuda.empty_cache()
    ref = runs["atlas (halo)"]
    out = {"gather_voxels": list(gather.tpu.voxels)}
    for name in ("brick (side 8, region)", "gather"):
        worst = 0.0
        for i, v in enumerate(sub[1]):
            got, want = runs[name]["scores"][i], ref["scores"][i]
            np.testing.assert_allclose(got, want, rtol=HASH_RTOL, atol=HASH_ATOL,
                                       err_msg=f"12b {name} scan {i} vs the atlas engine")
            worst = max(worst, float(np.abs(got - want)[v].max()))
            for key in ("n_scan_voxels", "n_submap_voxels", "n_kept"):
                if int(runs[name]["stats"][i][key]) != int(ref["stats"][i][key]):
                    raise AssertionError(f"12b {name} scan {i}: {key} differs from the atlas's")
        log(f"  {name} vs atlas (halo): max |dscore| {worst:.3e} over {len(sub[0])} scans")
        out[name] = worst
    return out


def engine_profile(filt, data, card, label, n=4):
    """torch.profiler over n scans of a hash engine: kernel ms and launches a
    scan, device busy share, and the sps.hash.build / sps.hash.lookup /
    sps.stage.topo / sps.model ranges (host ms, kernel ms and calls a scan).
    The pyramid is built in sps.stage.topo, outside sps.model; their sum,
    "model + pyramid", is the whole of the rebuild after stage 1."""
    scans, valids, labels = data
    pose = np.eye(4, dtype=np.float32)
    n = min(n, len(scans))
    kernels, ranges, wall_us = profiled(lambda i: filt(scans[i], valids[i], labels[i], pose), n)
    busy = sum(_device_us(e) for e in kernels)
    out = dict(kernel_ms=busy / n / 1e3, launches=sum(e.count for e in kernels) / n,
               busy=busy / wall_us, wall_ms=wall_us / n / 1e3)
    keys = ("sps.hash.build", "sps.hash.lookup", "sps.stage.topo", "sps.model")
    for key in keys:
        r = ranges.get(key, dict(count=0, host_us=0.0, kernel_us=0.0, span_us=0.0))
        out[key] = dict(calls=r["count"] / n, host_ms=r["host_us"] / n / 1e3,
                        kernel_ms=r["kernel_us"] / n / 1e3, span_ms=r["span_us"] / n / 1e3)
    out["model_and_pyramid_kernel_ms"] = (out["sps.stage.topo"]["kernel_ms"]
                                          + out["sps.model"]["kernel_ms"])
    log(f"  profile ({label}, {n} scans) [{card}]: kernels {out['kernel_ms']:.2f} ms and "
        f"{out['launches']:.0f} launches a scan, device busy {100 * out['busy']:.1f}%, wall "
        f"{out['wall_ms']:.2f} ms a scan; " + "; ".join(
            f"{k} x{out[k]['calls']:.0f}: host {out[k]['host_ms']:.2f} ms, kernels "
            f"{out[k]['kernel_ms']:.2f} ms, span {out[k]['span_ms']:.2f} ms"
            for k in keys) + f" a scan; model + pyramid kernels "
        f"{out['model_and_pyramid_kernel_ms']:.2f} ms a scan")
    for e in sorted(kernels, key=_device_us, reverse=True)[:8]:
        log(f"    kernel {_device_us(e) / n / 1e3:8.3f} ms a scan x{e.count // n:5d}  "
            f"{e.key[:90]}")
    return out


def hash_rounds(filt, data):
    """The probe loops' rounds in one scan, by kind: the build's two
    full-width rounds, the narrow loops (compacted rows), and the
    full-width cleanups (rows that compaction could not take). Returns
    {kind: [loops, rounds, query-rounds]} (query-rounds: rounds times the
    loop's width)."""
    from sps_torch.ops import hash as vhash

    real, out = vhash._rounds, {"full width, build's first two": [0, 0, 0],
                                "narrow": [0, 0, 0], "full-width cleanup": [0, 0, 0]}

    def counted(step, pending, max_rounds, first_test):
        n = [0]

        def one():
            n[0] += 1
            step()

        real(one, pending, max_rounds, first_test)
        kind = ("narrow" if first_test == vhash.SYNC_EVERY else "full-width cleanup"
                if first_test == 0 else "full width, build's first two")
        rec = out[kind]
        rec[0], rec[1], rec[2] = rec[0] + 1, rec[1] + n[0], rec[2] + n[0] * pending().numel()

    scans, valids, labels = data
    vhash._rounds = counted
    try:
        filt(scans[0], valids[0], labels[0], np.eye(4, dtype=np.float32))
    finally:
        vhash._rounds = real
    return out


def int8_checked(filt, data):
    """One scan of the brick engine with INT8 on, every int8 conv's inputs and
    output recorded (ops/brick.py _int8_gather: one launch, or six for C =
    192); each output against the plain version of the whole call, bit for
    bit. Returns (calls, launches in the scan)."""
    import torch

    from sps_torch.ops import brick as bk
    from sps_torch.ops import brick_conv_int8 as bi8

    real, calls = bk._int8_gather, []

    def recording(q, nbr27, w8, scale, out_dtype):
        out = real(q, nbr27, w8, scale, out_dtype)
        calls.append((q, nbr27, w8, scale, out_dtype, out))
        return out

    scans, valids, labels = data
    bk._int8_gather = recording
    try:
        reset_counts()
        filt(scans[0], valids[0], labels[0], np.eye(4, dtype=np.float32))
        torch.cuda.synchronize()
        launches = read_counts()["brick_conv_int8_gather"]
    finally:
        bk._int8_gather = real
    shapes = []
    for q, nbr27, w8, scale, out_dtype, out in calls:
        want = bi8.brick_conv_int8_gather_ref(q, nbr27, w8, scale, out_dtype)
        if not torch.equal(out, want):
            raise AssertionError(f"12c brick int8 call C {q.shape[-1]} -> N {w8.shape[-1]} "
                                 f"(B {nbr27.shape[1]}): not bit-equal to its plain version")
        shapes.append((int(nbr27.shape[1]), int(q.shape[-1]), int(w8.shape[-1])))
    return shapes, launches


def phase_engines_times(card, shipped, sd, stable, data, gather_voxels):
    """12c: bf16 at BLT scale, config.yaml with ENGINE gather (VOXELS as 12b
    settled them), ENGINE brick with CONV_MODE region (INT8 off, then on):
    p50 ms a scan over phase 6's ten scans, host syncs a scan, peak memory,
    launch counts; a profile of four scans (kernel ms and launches a scan,
    the hash build and lookup ranges); with INT8 on, every int8 conv of a
    scan bit for bit against its plain version."""
    import torch

    log("phase 12c: the hash engines' times (config.yaml, bf16, BLT scale, full width)")
    zero = {"zband_conv": routes(),
            "zband_conv_fused": routes(),
            "brick_conv_int8": 0, "brick_conv_int8_gather": 0}
    n_scans = len(data[0])
    paths = {"gather": (twin(shipped, engine="gather", voxels=tuple(gather_voxels)), 0),
             "brick region": (twin(shipped, engine="brick", conv_mode="region", int8=False), 0),
             "brick region INT8": (twin(shipped, engine="brick", conv_mode="region", int8=True),
                                   BRICK_INT8_LAUNCHES)}
    out = {}
    for name, (cfg, per_scan) in paths.items():
        (filt, run), syncs = hash_syncs(lambda: drive(cfg, sd, stable, data))
        p50 = hash_run_checks(run, f"12c {name}")
        check_launches(run, dict(zero, brick_conv_int8_gather=per_scan * n_scans), f"12c {name}")
        log(f"  {name} [{card}]: per-scan latency ms {[round(x, 2) for x in run['lat']]}; p50 "
            f"{p50:.2f} ms; {syncs / n_scans:.1f} host syncs a scan; peak device memory "
            f"{run['peak'] / 2**30:.2f} GiB")
        prof = engine_profile(filt, data, card, f"12c {name}")
        rounds = hash_rounds(filt, data)
        log(f"  {name}: probe loops in one scan (loops, rounds, query-rounds): " + "; ".join(
            f"{k} {v[0]}, {v[1]}, {v[2]:,}" for k, v in rounds.items()))
        rec = dict(p50=p50, lat=run["lat"], syncs=syncs / n_scans, peak=run["peak"],
                   launches=run["launches"], profile=prof, rounds=rounds, scores=run["scores"])
        if per_scan:
            shapes, launches = int8_checked(filt, data)
            if launches != per_scan:
                raise AssertionError(f"12c {name}: {launches} int8 launches in a scan, "
                                     f"expected {per_scan}")
            log(f"  {name}: {len(shapes)} int8 convs a scan ({launches} launches) bit-equal to "
                f"their plain versions; (B, C, N): {shapes}")
            rec["int8_calls"] = shapes
        out[name] = rec
        del filt
        torch.cuda.empty_cache()
    for name in ("brick region", "brick region INT8"):
        d = max(float(np.abs(a - b)[v].max()) for a, b, v in
                zip(out[name]["scores"], out["gather"]["scores"], data[1]))
        log(f"  {name} vs gather (bf16): max |dscore| {d:.4e}")
        out[name]["vs_gather"] = d
    for rec in out.values():
        del rec["scores"]
    return out


# Phase 13a: the zband path with ZBAND_LEVELS 2 and 3. Fused convs a scan
# (the BasicBlock convs of the folded levels), by ZBAND_LEVELS.
ZBAND_LEVEL_FUSED = {1: 2, 2: 6, 3: 10}
# The BasicBlock convs that ZBAND_LEVELS 2 / 3 fold at L1 / L2, full width,
# batch 1: (call, level, calls a scan at ZBAND_LEVELS 3, TCin, TCout,
# residual); B is the level's brick capacity. K2's kernel is "wgmma" at each.
# 13a counts the launches at each shape in its ZBAND_LEVELS 3 run and holds
# them to this table.
ZBAND_L12_CALLS = [
    ("block1_0.conv1/conv2", 1, 2, 16, 16, True), ("block7_0.conv1", 1, 1, 48, 32, False),
    ("block7_0.conv2", 1, 1, 32, 32, True), ("block2_0.conv1", 2, 1, 16, 32, False),
    ("block2_0.conv2", 2, 1, 32, 32, True), ("block6_0.conv1", 2, 1, 96, 64, False),
    ("block6_0.conv2", 2, 1, 64, 64, True),
]


def zband_l12_calls(card, caps, shape_launches, n_scans):
    """K2 at the L1 / L2 shapes against its plain version (bf16, max error
    within 2e-2 of the output's max-abs) and timed beside the plain version
    and F.conv2d on the same operands, with the bound (band zeros counted,
    and the 3^3 conv's own work beside it). shape_launches: the ZBAND_LEVELS
    3 run's launches per shape over n_scans scans; each shape's count must
    be ZBAND_L12_CALLS's, and the rest (L0's two a scan) ZBAND_LEVEL_FUSED[1]'s."""
    import torch
    import torch.nn.functional as F

    fused = {key: n for key, n in shape_launches.items() if key[0] == "zband_conv_fused"}
    log(f"  zband_conv_fused launches by shape over {n_scans} scans at ZBAND_LEVELS 3: "
        + ", ".join(f"{key[1]} hz{key[2]} wz{key[3]}: {n}" for key, n in fused.items()))
    calls = []
    for i, (call, level, per_scan, tcin, tcout, wres) in enumerate(ZBAND_L12_CALLS):
        c = make_case(3, 8, tcin, tcout, caps[level], torch.bfloat16, seed=200 + i,
                      with_res=wres)
        key = ("zband_conv_fused", "wgmma", tuple(c["hz"].shape), tuple(c["wz"].shape))
        launches = fused.pop(key, 0)
        if launches != per_scan * n_scans:
            raise AssertionError(f"13a L{level} {call}: {launches} launches at {key[2:]} over "
                                 f"{n_scans} scans, expected {per_scan} a scan")
        tag = f"L{level} {call} hz{tuple(c['hz'].shape)} N={c['wz'].shape[-1]} bfloat16"
        err = check("zband_conv_fused", c, True, tag, "wgmma")
        x_nchw = c["hz"].permute(0, 3, 1, 2)
        w_oihw = c["wz"].permute(3, 2, 0, 1)
        ms = time_ms(lambda: run_kernel("zband_conv_fused", c))
        plain_ms = time_ms(lambda: run_plain("zband_conv_fused", c))
        library_ms = time_ms(lambda: F.conv2d(x_nchw, w_oihw))
        flops, nbytes = work(c, True)
        bound_ms = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
        bound_by = "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_HBM_BYTES else "bytes"
        # The 3^3 conv the band encodes, without the band's zeros: 27 taps of
        # TCin x TCout a voxel, bs^3 voxels a brick.
        conv_flops = 2 * c["hz"].shape[0] * 8**3 * 27 * tcin * tcout
        conv_bound_ms = max(conv_flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
        calls.append(dict(name="zband_conv_fused", call=f"L{level} {call}", route="wgmma",
                          source=route_source("wgmma"), launches_zband_levels_3=launches,
                          launches_a_scan_zband_levels_3=launches / n_scans,
                          hz=list(c["hz"].shape), wz=list(c["wz"].shape), max_abs_err=err,
                          ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                          bound_by=bound_by, gflop=flops / 1e9, gbytes=nbytes / 1e9,
                          conv_gflop=conv_flops / 1e9, conv_bound_ms=conv_bound_ms))
        log(f"  time zband_conv_fused L{level} {call:21s} bf16 [{card}]: kernel (wgmma) "
            f"{ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} ms, F.conv2d "
            f"{library_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}; {flops / 1e9:.1f} GFLOP, "
            f"{nbytes / 1e9:.3f} GB); the conv without band zeros {conv_flops / 1e9:.1f} GFLOP, "
            f"bound {conv_bound_ms:.3f} ms; {launches} launches in 13a's ZBAND_LEVELS 3 run")
        del c, x_nchw, w_oihw
        torch.cuda.empty_cache()
    l0 = sum(fused.values())
    if l0 != ZBAND_LEVEL_FUSED[1] * n_scans:
        raise AssertionError(f"13a: {l0} launches at shapes outside ZBAND_L12_CALLS ({fused}), "
                             f"expected L0's {ZBAND_LEVEL_FUSED[1]} a scan")
    return calls


def phase_zband_levels(card, shipped, sd, stable, data, zband1, profile):
    """13a: phase 4's path at ZBAND_LEVELS 2 and 3: launches per route a
    scan, scores against the ZBAND_LEVELS 1 run (phase 4) within the bf16
    bound 0.05, kernel ms and launches a scan with --profile; then K2 at the
    L1 / L2 shapes against its plain version and timed."""
    import torch

    log("phase 13a: zband path at ZBAND_LEVELS 2 and 3 (config.yaml, zband, int8 off, bf16)")
    n_scans = len(data[0])
    out = {}
    for zl in (2, 3):
        cfg = twin(shipped, conv_mode="zband", zband_levels=zl, int8=False)
        filt, run = drive(cfg, sd, stable, data)
        label = f"zband_levels {zl}"
        rec = dict(p50=check_run(run, data[1], cfg.tpu.topo_every, card, label),
                   launches=run["launches"], shape_launches=run["shape_launches"],
                   peak=run["peak"])
        check_launches(run, {"zband_conv": routes(wgmma_k5=n_scans),
                             "zband_conv_fused": routes(wgmma=ZBAND_LEVEL_FUSED[zl] * n_scans),
                             "brick_conv_int8": 0, "brick_conv_int8_gather": 0}, label)
        rec["vs_levels_1"] = compare_runs(run, zband1, data[1], cfg.threshold, 0.05,
                                          f"{label} vs ZBAND_LEVELS 1 (phase 4)")
        if profile:
            rec["profile"] = filter_kernel_ms(filt, data, card, label)
        out[zl] = rec
        del filt
        torch.cuda.empty_cache()
    if profile:
        filt, _ = drive(twin(shipped, conv_mode="zband", zband_levels=1, int8=False), sd, stable,
                        data)
        out[1] = dict(profile=filter_kernel_ms(filt, data, card, "zband_levels 1"))
        del filt
        torch.cuda.empty_cache()
    return out, zband_l12_calls(card, shipped.sps_config(1).caps.bricks,
                                out[3]["shape_launches"], n_scans)


FORM_SCANS = 3
DEVICES = {"card": "cuda", "cpu": "cpu"}
FORM_FIELDS = ("nbr27", "parent", "oct", "child", "parent_rows", "brick_of_row",
               "lflat_of_row", "parity")


def cpu_scan_grid(filt, scan, valid):
    """The rebuild program's stride-1 grid of a scan on the filter's device
    (the CPU's here; StreamingFilter.stage_vox: pose, quantize, voxelize,
    the map-overlap bit): (grid, point2slot, t_idx, valid)."""
    import torch

    vx = filt.stage_vox(torch.as_tensor(scan)[None], torch.as_tensor(valid)[None],
                        torch.eye(4)[None])
    return vx.grid, vx.p2v, vx.t_idx, vx.valid


def phase_atlas_forms(card, shipped, sd, stable, data):
    """13b: the atlas engine's other pyramids at config.yaml in f32 (INT8
    off, TF32 off): the all-brick pyramid (ROW_FROM 0) and the hybrid form
    (ROW_FROM 2 at side 8, atlas.hybridize_levels; VOXELS raised where a
    scan needs more rows, as gather_twin does) on phase 6's first
    FORM_SCANS scans. Each scan's stride-1 grid is built once on the CPU
    (the rebuild program's steps): on the card the points' quantization
    differs from the CPU's by an ulp at a few voxel faces (ROADMAP.md §3),
    which would move voxels; from the same grid the pyramid's tables on the
    card equal the CPU's, its scores are within 1e-5 of the CPU's and within
    1e-4 of the aliased pyramid's on the card (phase 12b's bound), no
    overflow. Then each form's StreamingFilter on the card over the same
    scans, rebuilding every scan, against the aliased pyramid's filter
    within 1e-4, no overflow."""
    import torch

    from sps_torch.models import spsnet
    from sps_torch.stream.engine import StreamingFilter

    log("phase 13b: atlas forms (all-brick, hybrid ROW_FROM 2), f32, card vs CPU")
    part = tuple(a[:FORM_SCANS] for a in data)
    voxels = gather_twin(shipped, part).tpu.voxels
    forms = {"aliased": twin(shipped, int8=False, bf16=False),
             "all-brick": twin(shipped, row_from=0, int8=False, bf16=False),
             "hybrid ROW_FROM 2": twin(shipped, row_from=2, voxels=voxels, int8=False,
                                       bf16=False)}
    base = StreamingFilter(forms["aliased"], sd, stable, device="cpu")
    grids = [cpu_scan_grid(base, part[0][i], part[1][i]) for i in range(FORM_SCANS)]
    aliased = []
    out = {}
    for name, cfg in forms.items():
        scfg = cfg.sps_config(1)
        models = {}
        # The aliased pyramid (phases 3, 6 and 12b hold it) runs on the card only.
        for where in ("card",) if name == "aliased" else ("card", "cpu"):
            m = spsnet.SPSModel(scfg)
            m.load_state_dict(sd, strict=True)
            models[where] = m.to(DEVICES[where]).eval()
        worst, worst_alias, kinds = 0.0, 0.0, None
        for i, (grid, p2s, ones, vflat) in enumerate(grids):
            res = {}
            for where, m in models.items():
                dev = DEVICES[where]
                g = grid._replace(**{f: getattr(grid, f).to(dev) for f in
                                     ("coords", "occ", "num_bricks", "atlas", "origin",
                                      "overflow")})
                with torch.inference_mode():
                    levels, ov = spsnet.build_levels_from_grid(g, scfg)
                    s, aux = m(levels=levels, p2v=p2s.to(dev), t_idx=ones.to(dev),
                               valid=vflat.to(dev))
                res[where] = (s.cpu(), bool(ov.any() | aux["overflow"].any()), levels)
            kinds = [type(lv).__name__ for lv in res["card"][2]]
            if name == "aliased":
                aliased.append(res["card"][0])
                if res["card"][1]:
                    raise AssertionError(f"13b aliased scan {i}: capacity overflow")
                continue
            for li, (a, b) in enumerate(zip(res["card"][2], res["cpu"][2])):
                for f in FORM_FIELDS:
                    ta, tb = getattr(a, f, None), getattr(b, f, None)
                    if ta is not None and not torch.equal(ta.cpu(), tb):
                        raise AssertionError(f"13b {name} scan {i}: L{li} {f} card != CPU")
                if not torch.equal(a.grid.occ.cpu(), b.grid.occ):
                    raise AssertionError(f"13b {name} scan {i}: L{li} occupancy card != CPU")
            d = float((res["card"][0] - res["cpu"][0]).abs().max())
            da = float((res["card"][0] - aliased[i]).abs().max())
            worst, worst_alias = max(worst, d), max(worst_alias, da)
            log(f"  {name} scan {i}: tables card = CPU; max |score_card - score_cpu| {d:.3e}, "
                f"vs the aliased pyramid on the card {da:.3e}; overflow {res['card'][1]}/"
                f"{res['cpu'][1]}")
            if res["card"][1] or res["cpu"][1]:
                raise AssertionError(f"13b {name} scan {i}: capacity overflow")
            if not (d <= 1e-5 and da <= 1e-4):
                raise AssertionError(f"13b {name} scan {i}: |dscore| {d} (CPU) / {da} (aliased)")
        if name == "aliased":
            continue
        out[name] = dict(max_dscore=worst, vs_aliased=worst_alias, levels=kinds)
        log(f"  {name} {kinds}: max |dscore| card vs CPU {worst:.3e} (bound 1e-5), vs the "
            f"aliased pyramid {worst_alias:.3e} (bound 1e-4) over {FORM_SCANS} scans [{card}]")
        del models
        torch.cuda.empty_cache()
    # The card's own rebuild program on each form (StreamingFilter: voxelize,
    # build_levels_from_grid, hybridize_levels) on every scan (TOPO_EVERY 0:
    # a hybridized pyramid has no topology reuse, refresh_occupancy raises on
    # it as sps_tpu's asserts), held against the aliased pyramid's filter in
    # this run: one card voxelization for all three, so phase 12b's 1e-4
    # holds; no overflow.
    runs = {}
    for name, cfg in forms.items():
        cfg = twin(cfg, topo_every=0)
        filt, run = drive(cfg, sd, stable, part)
        p50 = check_run(run, part[1], 1, card, f"13b {name} StreamingFilter")
        if name != "aliased":
            out[name]["filter_vs_aliased"] = compare_runs(
                run, runs["aliased"], part[1], cfg.threshold, 1e-4,
                f"13b {name} StreamingFilter vs the aliased one on the card")
            out[name]["filter_p50"] = p50
        runs[name] = run
        del filt
        torch.cuda.empty_cache()
    return out


# Phase 14: sp and dp. SP_SCANS of phase 6's scans; the ghost runs' ghost
# capacity a fraction of a block: on 2 ranks a BLT scan's blocks reference
# up to a quarter of a block in the other's (at 0.25, L2 and L3 overflow).
SP_SCANS = 3
SP_GHOST_FRAC = 0.5
SP_RANKS = 2


def sp_runs(shipped):
    """The sp filters of 14b: (label, config, ghost_frac). head_fold and the
    fused z-band epilogue are off under sp, and topology reuse."""
    zband = twin(shipped, conv_mode="zband", zband_levels=1, int8=False)
    return [("shipped", shipped, 0.0), ("shipped ghost", shipped, SP_GHOST_FRAC),
            ("int8-off f32 ghost", twin(shipped, int8=False, bf16=False), SP_GHOST_FRAC),
            ("zband", zband, 0.0)]


def one_rank_twin(cfg):
    """The one-rank filter an sp run is held to: its options as the sp model
    runs them (no HEAD_FOLD, the rebuild program every scan)."""
    return twin(cfg, head_fold=False, topo_every=0)


def run_filter(filt, data, n):
    """(scores, stats, per-scan ms) of the filter over n scans."""
    import torch

    scans, valids, labels = data
    pose = np.eye(4, dtype=np.float32)
    lat, scores, stats = [], [], []
    for i in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        s, _, st = filt(scans[i], valids[i], labels[i], pose)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
        scores.append(s.float().cpu().numpy())
        stats.append({k: float(v) for k, v in st.items()})
    return scores, stats, lat


def _rank_setup():
    import torch

    from sps_torch.ops import zband_conv as zc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    zc.build()


def sp_rank(rank, world, shipped, sd, stable, data):
    """14b, one of the ranks on the card (gloo, collectives staged through
    the host): every sp filter of sp_runs over the scans, launch counts and
    host copies set to 0 just before each and read just after."""
    from sps_torch.parallel import comm
    from sps_torch.parallel import mesh as pm
    from sps_torch.stream.engine import StreamingFilter

    _rank_setup()
    mesh = pm.make_mesh(world, "sp")
    out = {}
    for label, cfg, frac in sp_runs(shipped):
        filt = StreamingFilter(cfg, sd, stable, mesh=mesh, sp_ghost_frac=frac)
        reset_counts()
        comm.reset_counts()
        scores, stats, lat = run_filter(filt, data, len(data[0]))
        out[label] = dict(scores=scores, stats=stats, lat=lat, launches=read_counts(),
                          host_staged=comm.HOST_STAGED["copies"])
    return out


def phase_one_rank_nccl(card, shipped, sd, stable, data):
    """14a: one rank on NCCL. The sp filter over a one-rank "sp" mesh at
    config.yaml (INT8, bf16) bit-equal to the same filter without a group
    (both with the sp model's options, one_rank_twin), and the dp step over
    a one-rank "dp" mesh at config.yaml (bf16, batch 1) against the step
    without a group: the parameters and BN statistics after it differ by no
    more than two runs of the step without a group differ from each other
    (0 where the step is deterministic on the card; deterministic algorithms
    on where PyTorch has them)."""
    import torch
    import torch.distributed as dist

    from sps_torch import train
    from sps_torch.parallel import launch
    from sps_torch.parallel import mesh as pm
    from sps_torch.stream.engine import StreamingFilter

    log("phase 14a: one rank on NCCL (sp filter and dp step at config.yaml against no group)")
    part = tuple(a[:SP_SCANS] for a in data)
    launch.init(0, 1, launch.free_port(), "nccl")
    out = {}
    try:
        cfg = one_rank_twin(shipped)
        a, _, _ = run_filter(StreamingFilter(cfg, sd, stable), part, SP_SCANS)
        b, st, lat = run_filter(StreamingFilter(cfg, sd, stable, mesh=pm.make_mesh(1, "sp")),
                                part, SP_SCANS)
        same = all(np.array_equal(x, y) for x, y in zip(a, b))
        log(f"  sp filter, one NCCL rank, {SP_SCANS} scans: scores bit-equal to no group: "
            f"{same}; p50 {statistics.median(lat):.2f} ms [{card}]")
        if not same or any(s["overflow"] for s in st):
            raise AssertionError("14a: the one-rank sp filter differs from the filter")
        out["sp_bit_equal"] = same
        torch.cuda.empty_cache()

        mesh = pm.make_mesh(1, "dp")
        step = pm.make_dp_train_step(shipped, mesh, augment=False)
        mp = torch.as_tensor(stable, device="cuda")
        batch = {k: torch.as_tensor(v[:1], device="cuda")
                 for k, v in (("xyz", data[0]), ("valid", data[1]), ("label", data[2]))}

        def stepped(dp):
            state = train.create_state(shipped, 0, 1)
            if dp:
                m = step(state, batch, mp)
            else:
                m = train.train_step(state, batch, mp, cfg=shipped, augment=False)
            flat = torch.cat([v.float().reshape(-1) for v in state.model.state_dict().values()])
            loss = float(m["loss"])
            del state
            torch.cuda.empty_cache()
            return flat.cpu(), loss

        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            (p1, l1), (p2, l2), (pd, ld) = stepped(False), stepped(False), stepped(True)
        finally:
            torch.use_deterministic_algorithms(False)
        spread = float((p1 - p2).abs().max())
        diff = float((pd - p1).abs().max())
        log(f"  dp step, one NCCL rank: loss {ld:.6f} (no group {l1:.6f}, {l2:.6f}); max "
            f"|param_dp - param_no_group| {diff:.3e}, two runs without a group differ by "
            f"{spread:.3e}")
        if not (np.isfinite(ld) and diff <= spread):
            raise AssertionError("14a: the one-rank dp step differs from the step")
        out.update(dp_max_diff=diff, no_group_spread=spread, loss=ld)
    finally:
        dist.destroy_process_group()
    return out


def phase_sp_ranks(card, shipped, sd, stable, data):
    """14b: SP_RANKS ranks spawned on the one card over gloo (NCCL refuses
    two ranks on one card; every collective is staged through the host), the
    sp filters of sp_runs on phase 6's first SP_SCANS scans, each rank's
    scores against the one-rank filter (one_rank_twin): INT8 at ghost_frac 0
    within the int8 tolerance (check_int8_parity), INT8 with ghosts within
    0.1 (the int8 scale is a shard's own), INT8-off f32 with ghosts within
    1e-5, the zband path within the bf16 bound 0.05 (the sp model runs the
    unfused z-band kernel); the ranks' scores equal; 10 int8 gather launches
    a scan on each rank with INT8; no overflow; host copies and p50."""
    import torch

    from sps_torch.parallel import launch
    from sps_torch.stream.engine import StreamingFilter

    log(f"phase 14b: sp on {SP_RANKS} ranks spawned on the one card (gloo, host-staged)")
    part = tuple(a[:SP_SCANS] for a in data)
    t = time.time()
    ranks = launch.spawn(sp_rank, SP_RANKS, shipped, sd, stable, part, backend="gloo",
                         timeout=900.0)
    log(f"  ranks done in {time.time() - t:.1f} s")
    eps = shipped.threshold
    want = {}
    out = {}
    for label, cfg, frac in sp_runs(shipped):
        key = (cfg.tpu.int8, cfg.tpu.bf16, cfg.tpu.conv_mode)
        if key not in want:
            want[key] = run_filter(StreamingFilter(one_rank_twin(cfg), sd, stable), part,
                                   SP_SCANS)[0]
            torch.cuda.empty_cache()
        ref = want[key]
        rec = {}
        for r, res in enumerate(ranks):
            run = res[label]
            d = max(float(np.abs(a - b)[v].max()) for a, b, v in zip(run["scores"], ref, part[1]))
            if label == "shipped":
                for a, b, v in zip(run["scores"], ref, part[1]):
                    check_int8_parity(a, b, v, eps)
                bound = INT8_ATOL
            else:
                bound = {"shipped ghost": 0.1, "int8-off f32 ghost": 1e-5, "zband": 0.05}[label]
            int8 = run["launches"]["brick_conv_int8_gather"]
            log(f"  rank {r} {label:19s} (ghost_frac {frac}): max |dscore| vs one rank {d:.3e} "
                f"(bound {bound}); int8 gather launches {int8}; host copies "
                f"{run['host_staged']} ({run['host_staged'] / SP_SCANS:.0f} a scan); p50 "
                f"{statistics.median(run['lat']):.2f} ms; overflow "
                f"{[bool(s['overflow']) for s in run['stats']]} [{card}]")
            if not d <= bound:
                raise AssertionError(f"14b {label} rank {r}: |dscore| {d} exceeds {bound}")
            if any(s["overflow"] for s in run["stats"]):
                raise AssertionError(f"14b {label} rank {r}: overflow (ghost capacity?)")
            if int8 != (10 * SP_SCANS if cfg.tpu.int8 else 0):
                raise AssertionError(f"14b {label} rank {r}: {int8} int8 gather launches")
            rec[r] = dict(max_dscore=d, int8_launches=int8, host_staged=run["host_staged"],
                          p50=statistics.median(run["lat"]), launches=run["launches"])
        if not all(np.array_equal(a, b) for a, b in zip(ranks[0][label]["scores"],
                                                         ranks[1][label]["scores"])):
            raise AssertionError(f"14b {label}: the ranks' scores differ")
        out[label] = rec
    return out


def dp_rank(rank, world, shipped, stable, data):
    """14c, one of the ranks on the card (gloo): the dp step at config.yaml
    (bf16, augmentation off) on a batch of `world` scans, one a rank, three
    times; the first a warm-up."""
    import torch

    from sps_torch import train
    from sps_torch.parallel import comm
    from sps_torch.parallel import mesh as pm

    _rank_setup()
    mesh = pm.make_mesh(world, "dp")
    step = pm.make_dp_train_step(shipped, mesh, augment=False)
    state = train.create_state(shipped, 0, 1)
    mp = torch.as_tensor(stable, device="cuda")
    batch = {k: torch.as_tensor(v[:world], device="cuda")
             for k, v in (("xyz", data[0]), ("valid", data[1]), ("label", data[2]))}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    comm.reset_counts()
    reset_counts()
    ms, losses = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = step(state, batch, mp)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        losses.append(float(m["loss"]))
    flat = torch.cat([v.float().reshape(-1) for v in state.model.state_dict().values()])
    return dict(ms=ms, losses=losses, peak=torch.cuda.max_memory_allocated(),
                params=flat.cpu().numpy(), launches=read_counts(),
                host_staged=comm.HOST_STAGED["copies"], overflow=bool(m["overflow"]))


def phase_dp_ranks(card, shipped, stable, data):
    """14c: a dp-2 training step at config.yaml (bf16, batch 1 a rank) on
    two ranks spawned on the one card: the parameters bit-equal across the
    ranks after each step, finite losses, step ms (the steps after the
    first) and peak memory per rank, no z-band or int8 launch."""
    from sps_torch.parallel import launch

    log("phase 14c: a dp-2 training step at config.yaml, two ranks on the one card (gloo)")
    ranks = launch.spawn(dp_rank, 2, shipped, stable, tuple(a[:2] for a in data),
                         backend="gloo", timeout=900.0)
    out = {}
    for r, res in enumerate(ranks):
        log(f"  rank {r}: losses {[round(x, 6) for x in res['losses']]}, step ms "
            f"{[round(x, 1) for x in res['ms']]}, peak {res['peak'] / 2**30:.2f} GiB, host "
            f"copies {res['host_staged']}, launches {res['launches']} [{card}]")
        if not np.isfinite(res["losses"]).all() or res["overflow"]:
            raise AssertionError(f"14c rank {r}: loss {res['losses']}, overflow {res['overflow']}")
        no_train_launches([{"launches": res["launches"]}], f"14c rank {r}")
        out[r] = dict(step_ms=statistics.median(res["ms"][1:]), ms=res["ms"], peak=res["peak"],
                      losses=res["losses"], host_staged=res["host_staged"])
    same = np.array_equal(ranks[0]["params"], ranks[1]["params"])
    log(f"  parameters and BN statistics bit-equal across the ranks after 3 steps: {same}")
    if not same:
        raise AssertionError("14c: the ranks' parameters differ after the dp steps")
    return out


# Phase 15: the baselines trained on the card (15a), the localization-evidence
# workflow (15b), config_nclt.yaml at NCLT scale (15c).
BASELINE_TRAIN_STEPS = 5
BASELINE_PIN = os.path.join(HERE, "sps_torch", "assets", "baseline_train_pin.npz")
BASELINE_STEP_RECORDS = ("mos4d_f32", "mos4d", "mapmos", "lts")
BASELINE_STEP_TOL = 1e-4  # f32: of a leaf's max |grad| (floor: 1e-3 of the model's largest)
BASELINE_MOVE_REL = 1e-2  # f32: the Adam move of the entries above the noise, per leaf
BASELINE_ADAM_REL = 1e-3  # the card's move against Adam's first step of its gradient
# MOS4D in bf16: tests/test_torch_train_baselines.py's band (loss, cosine and
# relative L2 of all gradients, running statistics).
BASELINE_BF16_COSINE = 0.92
BASELINE_BF16_REL = 0.40
BASELINE_BF16_LOSS = 2.0**-9
BASELINE_BF16_STATS = 1.63e-3
NCLT_EXTENT = 110.0
NCLT_SCANS = 12


def compare_baseline_steps(record, card_step, cpu_step, lr):
    """Card step against CPU step, both from the same weights on the same
    batch. f32 records: the loss within rtol 1e-5, the gradients within
    BASELINE_STEP_TOL, the running statistics within 1e-5, and the move
    w1 - w0 of the entries whose CPU gradient stands above the noise (1e-3
    of its leaf's max and of the model's largest) within BASELINE_MOVE_REL
    relative L2 on each leaf. MOS4D in bf16 within its band. Every record:
    the card's move is Adam's first step of the card's own gradient,
    -lr g / (|g| + eps), within BASELINE_ADAM_REL relative L2. Returns
    (ok, the measured differences)."""
    import torch

    from sps_torch.scripts import train_baselines as tb

    gmax = max(float(g.abs().max()) for g in cpu_step["grads"].values())
    floor = 1e-3 * gmax
    loss_rel = abs(card_step["loss"] - cpu_step["loss"]) / abs(cpu_step["loss"])
    stats = [k for k in cpu_step["after"] if k not in cpu_step["grads"]
             and cpu_step["after"][k].is_floating_point()]
    s_err = max(float((card_step["after"][k] - cpu_step["after"][k]).abs().max()
                      / max(float(cpu_step["after"][k].abs().max()), 1.0)) for k in stats)
    moved = {k: (card_step["after"][k] - card_step["init"][k]).double()
             for k in card_step["grads"]}
    adam = torch.cat([(-lr * g.double() / (g.double().abs() + tb.ADAM["eps"])).reshape(-1)
                      for g in card_step["grads"].values()])
    adam_rel = float((torch.cat([m.reshape(-1) for m in moved.values()]) - adam).norm()
                     / adam.norm())
    if record == "mos4d":
        a = torch.cat([g.reshape(-1).double() for g in card_step["grads"].values()])
        b = torch.cat([g.reshape(-1).double() for g in cpu_step["grads"].values()])
        cos = float(a @ b / (a.norm() * b.norm()))
        rel = float((a - b).norm() / b.norm())
        ok = (loss_rel <= BASELINE_BF16_LOSS and cos >= BASELINE_BF16_COSINE
              and rel <= BASELINE_BF16_REL and s_err <= BASELINE_BF16_STATS
              and adam_rel <= BASELINE_ADAM_REL)
        res = dict(loss_rel=loss_rel, grad_cosine=cos, grad_rel_l2=rel, stats_rel_err=s_err,
                   adam_rel=adam_rel)
    else:
        g_err, worst = max((float((card_step["grads"][k] - g).abs().max())
                            / max(float(g.abs().max()), floor), k)
                           for k, g in cpu_step["grads"].items())
        move_rel = 0.0
        for k, g in cpu_step["grads"].items():
            live = g.abs() > max(1e-3 * float(g.abs().max()), floor)
            if live.any():
                want = (cpu_step["after"][k] - cpu_step["init"][k]).double()[live]
                move_rel = max(move_rel, float((moved[k][live] - want).norm() / want.norm()))
        ok = (loss_rel <= 1e-5 and g_err <= BASELINE_STEP_TOL and s_err <= 1e-5
              and move_rel <= BASELINE_MOVE_REL and adam_rel <= BASELINE_ADAM_REL)
        res = dict(loss_rel=loss_rel, grad_rel_err=g_err, move_rel_l2=move_rel,
                   stats_rel_err=s_err, adam_rel=adam_rel)
        log(f"  {record}: largest gradient difference in {worst}")
    return ok, res


def phase_baseline_training(card, root):
    """15a: the baseline trainers (sps_torch/scripts/train_baselines.py) on
    the card at the pipeline's sizes (config_loc_movers.yaml, the movers
    train split under `root`: SCAN_POINTS 12288 points a scan, MOS4D on a
    4-scan buffer, MapMOS against SUBMAP_POINTS 65536 map points, LTS with
    dropout), BASELINE_TRAIN_STEPS steps each: finite losses, every
    parameter tensor moved from the trainer's seeded weights, ms a step and
    peak memory, no kernel of sps_torch/csrc launched. Then one step of each
    record of baseline_train_pin.npz on the card against the same step on
    the CPU (TF32 off; f32 within BASELINE_STEP_TOL, MOS4D in bf16 within
    its band; LTS at dropout 0) and against the pin's loss (sps_tpu's), and
    run_localization with the new checkpoints (--baseline-weights) for
    mos4d, mapmos and lts on 20220629: finite ATEs. Returns the results and
    the checkpoint directory."""
    import torch

    from sps_torch import config
    from sps_torch.data import blt
    from sps_torch.models import lts
    from sps_torch.models.mapmos import MapMOSNet
    from sps_torch.models.mos4d import MOS4DNet
    from sps_torch.scripts import train_baselines as tb
    from sps_torch.stream import localize as loc
    from sps_torch.utils import checkpoint

    log("phase 15a: the baselines trained on the card (train_baselines at the pipeline's sizes)")
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 is on: phase 2 turns it off for the f32 comparisons")
    cfg = config.load(os.path.join(HERE, "config", "config_loc_movers.yaml"), data_root=root)
    scans, poses = blt.load_sequences_raw(root, cfg.data.train)
    mp = blt.load_map(root, cfg.data.map_file)
    out_dir = os.path.join(HERE, "build", "baselines_trained")
    shutil.rmtree(out_dir, ignore_errors=True)
    pps, nm, steps = cfg.tpu.scan_points, cfg.tpu.submap_points, BASELINE_TRAIN_STEPS
    runs = {
        "mos4d": (lambda: tb.train_mos4d(cfg, scans, poses, True, steps, 4, pps, out_dir, 0),
                  lambda: MOS4DNet(tb.mos4d_config(cfg, 4), torch.Generator().manual_seed(0))),
        "mapmos": (lambda: tb.train_mapmos(cfg, scans, poses, mp, steps, pps, nm, out_dir, 0),
                   lambda: MapMOSNet(tb.mapmos_config(cfg), torch.Generator().manual_seed(0))),
        "lts": (lambda: tb.train_lts(cfg, scans, steps, out_dir, 0), None)}
    trained = {}
    step_ms = []
    real_step = tb.train_step

    def timed_step(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_step(*a, **k)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        return out

    reset_counts()
    tb.train_step = timed_step
    try:
        for name, (train, init_model) in runs.items():
            step_ms.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            path, losses = train()
            torch.cuda.synchronize()
            trained[name] = dict(losses=losses, ms_a_step=(time.perf_counter() - t) * 1e3 / steps,
                                 step_ms=list(step_ms), path=path,
                                 peak=torch.cuda.max_memory_allocated())
    finally:
        tb.train_step = real_step
    for name, (_, init_model) in runs.items():
        losses, path, peak = (trained[name][k] for k in ("losses", "path", "peak"))
        first, rest = trained[name]["step_ms"][0], statistics.median(trained[name]["step_ms"][1:])
        if init_model is None:
            init = lts.init_state_dict(0, random_stats=False)
        else:
            init = init_model().state_dict()
        got = checkpoint.restore(path)["model"]
        params = [k for k, v in init.items() if k.endswith(("kernel", "weight", "bias", "scale"))]
        still = [k for k in params if torch.equal(got[k].cpu(), init[k])]
        trained[name].update(first_step_ms=first, step_ms_p50=rest)
        log(f"  {name}: {steps} steps, losses {[round(x, 4) for x in losses]}, "
            f"{trained[name]['ms_a_step']:.1f} ms a step with the sampling; train_step "
            f"{first:.1f} ms the first, p50 {rest:.1f} ms the rest (synchronised); peak "
            f"{peak / 2**30:.2f} GiB, {len(params) - len(still)} of {len(params)} parameter "
            f"tensors moved [{card}]")
        if not all(np.isfinite(losses)) or still:
            raise AssertionError(f"15a {name}: losses {losses}, parameters that did not move "
                                 f"{still}")
    launched = {k: v for k, v in read_counts().items()
                if (sum(v.values()) if isinstance(v, dict) else v)}
    if launched:
        raise AssertionError(f"a kernel of sps_torch/csrc ran in the baselines' training: "
                             f"{launched}")
    model = MOS4DNet(tb.mos4d_config(cfg, 4), torch.Generator().manual_seed(0)).cuda().train()
    opt = tb.adam(model, "mos4d")
    batch = next(tb.mos4d_batches(scans, poses, 4, pps, 0))
    tb.train_step(model, opt, lambda: tb.mos4d_loss(model, batch))
    kernels, _, wall_us = profiled(
        lambda i: tb.train_step(model, opt, lambda: tb.mos4d_loss(model, batch)), 2)
    trained["mos4d"]["profile"] = dict(
        kernel_ms=sum(_device_us(e) for e in kernels) / 2e3, wall_ms=wall_us / 2e3,
        launches=sum(e.count for e in kernels) / 2,
        top=[(e.key[:80], _device_us(e) / 2e3, e.count / 2)
             for e in sorted(kernels, key=_device_us, reverse=True)[:8]])
    log(f"  profile of a MOS4D step: kernels {trained['mos4d']['profile']['kernel_ms']:.1f} ms, "
        f"wall {trained['mos4d']['profile']['wall_ms']:.1f} ms, "
        f"{trained['mos4d']['profile']['launches']:.0f} launches; top: " + "; ".join(
            f"{k} {ms:.2f} ms x{n:.0f}" for k, ms, n in trained["mos4d"]["profile"]["top"])
        + f" [{card}]")
    del model, opt
    torch.cuda.empty_cache()
    z = np.load(BASELINE_PIN)
    meta = json.loads(str(z["meta"]))
    steps_cmp = {}
    for record in BASELINE_STEP_RECORDS:
        batch = tuple(z[f"{record}/batch/{i}"] for i in range(6)
                      if f"{record}/batch/{i}" in z.files)
        on_card = tb.pin_step(record, batch, meta, "cuda")
        on_cpu = tb.pin_step(record, batch, meta, "cpu")
        ok, res = compare_baseline_steps(record, on_card, on_cpu,
                                         tb.LR[record.removesuffix("_f32")])
        res.update(loss=on_card["loss"], loss_cpu=on_cpu["loss"],
                   loss_pin=float(z[f"{record}/loss"]))
        log(f"  step {record} card vs CPU: " + ", ".join(
            f"{k} {v:.3e}" for k, v in res.items()) + f" [{card}]")
        pin_band = BASELINE_BF16_LOSS if record == "mos4d" else 1e-5
        if not ok or abs(res["loss"] - res["loss_pin"]) > pin_band * abs(res["loss_pin"]):
            raise AssertionError(f"15a {record}: the card's step differs: {res}")
        steps_cmp[record] = res
    loc_cfg = config.load(os.path.join(HERE, "config", "config_loc_movers.yaml"),
                          data_root=root)
    locs, cache = {}, {}
    for mode in ("mos4d", "mapmos", "lts"):
        t = time.perf_counter()
        r = loc.run_localization(loc_cfg, {}, "20220629", mode, prior="odom", init_noise=0.05,
                                 baseline_weights=out_dir, cache=cache, log=lambda s: None)
        locs[mode] = dict(ate=r["ate_rmse"], kept=r["kept_frac_mean"],
                          wall_s=time.perf_counter() - t)
        log(f"  run_localization {mode} from {os.path.relpath(out_dir, HERE)}: ATE "
            f"{r['ate_rmse']:.4f} m, kept {r['kept_frac_mean']:.3f}, "
            f"{locs[mode]['wall_s']:.1f} s [{card}]")
        if not np.isfinite(r["ate_rmse"]):
            raise AssertionError(f"15a {mode}: ATE {r['ate_rmse']}")
    del cache
    torch.cuda.empty_cache()
    return {"trained": trained, "steps": steps_cmp, "localization": locs, "dir": out_dir}


def phase_workflow(card, root, baselines_dir):
    """15b: the localization-evidence workflow's CLIs at reduced depth on
    the movers data under `root`, with ckpt_loc_movers_v2 (its npz copied
    under build/, where calibration.json is written beside it):
    calibrate_threshold on the val sequence (4 scans; epsilon on the grid,
    F1 in [0, 1]); loc_experiment: one run x 20220629 x {sps, raw, sps@0.5}
    into a summary.md with those rows; loc_calibrate_ate on the grid
    {0.5, 0.99} with the baselines of 15a: calibration.json, its robustness
    window, and every (sequence, filter) of the table present (a failed
    entry, which the workflow logs and skips, fails the phase)."""
    from sps_torch.convert import ASSETS
    from sps_torch.scripts import calibrate_threshold, loc_calibrate_ate, loc_experiment

    log("phase 15b: the localization-evidence workflow (calibrate, table, ATE-optimal epsilon)")
    cfg_path = os.path.join(HERE, "config", "config_loc_movers_v2.yaml")
    work = os.path.join(HERE, "build", "workflow")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    weights = os.path.join(work, "ckpt_loc_movers_v2.npz")
    shutil.copyfile(os.path.join(ASSETS, "ckpt_loc_movers_v2.npz"), weights)
    shutil.copyfile(os.path.join(ASSETS, "ckpt_loc_movers_v2.config.json"),
                    weights + ".config.json")
    grid = [round(float(e), 3) for e in calibrate_threshold.EPSILON_GRID]
    t = time.perf_counter()
    best = calibrate_threshold.main(["-c", cfg_path, "-w", weights, "--data", root,
                                     "--max-scans", "4"])
    log(f"  calibrate_threshold: epsilon {best['epsilon']}, F1 {best['f1']}, precision "
        f"{best['precision']}, recall {best['recall']} on {best['points']} points of "
        f"{best['sequence']} ({time.perf_counter() - t:.1f} s) [{card}]")
    if best["epsilon"] not in grid or not 0 <= best["f1"] <= 1:
        raise AssertionError(f"15b calibrate_threshold: {best}")
    exp_out = os.path.join(work, "exp")
    t = time.perf_counter()
    lines = loc_experiment.main(["-c", cfg_path, "-w", weights, "--data", root, "-seq",
                                 "20220629", "--filters", "sps,raw,sps@0.5", "--init-noise",
                                 "0.05", "--out", exp_out, "--fresh"])
    exp_s = time.perf_counter() - t
    with open(os.path.join(exp_out, "summary.md")) as f:
        summary = f.read().splitlines()
    rows = [ln for ln in summary if ln.startswith("| odom | y | 20220629 |")]
    log(f"  loc_experiment ({exp_s:.1f} s): " + " / ".join(rows))
    if summary != lines or [r.split(" | ")[3] for r in rows] != ["sps", "raw", "sps@0.5"]:
        raise AssertionError(f"15b loc_experiment summary.md: {summary}")
    ate_out = os.path.join(work, "ate")
    filters = ["sps", "raw", "mos4d", "mapmos", "lts"]
    t = time.perf_counter()
    res = loc_calibrate_ate.main(["-c", cfg_path, "--data", root, "-w", weights, "--baselines",
                                  baselines_dir, "--grid", "0.5,0.99", "--runs", "1",
                                  "--filters", ",".join(filters), "--out", ate_out])
    ate_s = time.perf_counter() - t
    with open(os.path.join(work, "calibration.json")) as f:
        cal = json.load(f)
    with open(weights + ".config.json") as f:
        threshold = json.load(f)["threshold"]
    done = sorted((r["seq"], r["filter"]) for r in res["results"])
    want = sorted((s, f) for s in ("20220629", "20220629_clean") for f in filters)
    log(f"  loc_calibrate_ate ({ate_s:.1f} s): sweep " + ", ".join(
        f"eps {r['epsilon']}: ATE {r['ate_rmse']} kept {r['kept_frac']}" for r in cal["ate_sweep"])
        + f"; epsilon_ate {cal['epsilon_ate']}, window {cal['epsilon_robustness']['window']}; "
        "table " + ", ".join(f"{r['seq']}/{r['filter']} {r['ate_rmse']:.4f}"
                             for r in res["results"]) + f" [{card}]")
    if (done != want or cal["epsilon_ate"] not in (0.5, 0.99) or threshold != cal["epsilon_ate"]
            or not all(np.isfinite(r["ate_rmse"]) for r in res["results"])):
        raise AssertionError(f"15b loc_calibrate_ate: table {done}, calibration {cal}")
    return {"calibrate_threshold": best, "loc_experiment": rows, "loc_experiment_s": exp_s,
            "epsilon_ate": cal["epsilon_ate"], "ate_sweep": cal["ate_sweep"],
            "robustness": cal["epsilon_robustness"], "loc_calibrate_ate_s": ate_s,
            "table": {f"{r['seq']}/{r['filter']}": r["ate_rmse"] for r in res["results"]}}


def phase_nclt(card):
    """15c: check_nclt_headroom at config_nclt.yaml as shipped, extent
    NCLT_EXTENT and NCLT_SCANS scans (~6M map points), through its CLI
    entry point with every launch count set to 0 just before and read just
    after: no overflow, scores finite in (0, 1], the int8 gather form's
    launches by (B, C, N) equal to INT8_CALLS a scan at the levels' brick
    counts (reported a scan by level; no launch of the halo form or the
    z-band kernels), p50, peak memory, the filter's kernel ms and
    launches a scan (profiler, 8 scans); then the gather form at NCLT's
    L0-L2 brick counts bit for bit against its plain version at the ten
    calls' shapes, timed beside its bound, and the C = 192 split (six
    launches of 32 channels) at NCLT's L3 brick count bit-equal to one
    launch's plain version."""
    import torch

    from sps_torch import config
    from sps_torch.ops import brick as bk
    from sps_torch.ops import brick_conv_int8 as bi8
    from sps_torch.scripts import check_nclt_headroom
    from sps_torch.scripts.int8_variants import gather_bound

    log(f"phase 15c: config_nclt.yaml as shipped at {NCLT_EXTENT:g} m, {NCLT_SCANS} scans")
    cfg = config.load(os.path.join(HERE, "config", "config_nclt.yaml"))
    caps = cfg.sps_config(1).caps.bricks
    t = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out, per_scan, filt = check_nclt_headroom.main(
        ["--extent", f"{NCLT_EXTENT:g}", "--scans", str(NCLT_SCANS)])
    launches = read_counts()
    by_shape = dict(bi8.GATHER_SHAPE_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    wall = time.perf_counter() - t
    by_level = {lv: sum(n for (b, _, _), n in by_shape.items() if b == caps[lv]) / NCLT_SCANS
                for lv in (0, 1, 2)}
    lat = [r["ms"] for r in per_scan]
    p50 = statistics.median(lat)
    log(f"  {json.dumps(out)}; per scan (n_scan_voxels, topo_miss_points): "
        + ", ".join(f"({r['n_scan_voxels']}, {r['topo_miss_points']})" for r in per_scan))
    lo, hi = min(r["score_min"] for r in per_scan), max(r["score_max"] for r in per_scan)
    log(f"  p50 {p50:.2f} ms a scan (first {lat[0]:.1f} ms), peak {peak / 2**30:.2f} GiB, "
        f"{wall:.1f} s with the world and the map; scores in [{lo:.4f}, {hi:.4f}]; int8 "
        f"gather launches a scan by level "
        f"{by_level}, by (B, C, N) {by_shape}; all launches {launches} [{card}]")
    others = {k: v for k, v in launches.items() if k != "brick_conv_int8_gather"
              and (sum(v.values()) if isinstance(v, dict) else v)}
    want_shapes = {}
    for _, level, per, c, n in INT8_CALLS:
        key = (caps[level], c, n)
        want_shapes[key] = want_shapes.get(key, 0) + per * NCLT_SCANS
    if (out["overflow"] or out["scans"] != NCLT_SCANS
            or not all(0 < r["score_min"] <= r["score_max"] <= 1 for r in per_scan)
            or by_shape != want_shapes or others):
        raise AssertionError(f"15c: {out}, launches {launches}, by level {by_level}")
    _, scans, valids = check_nclt_headroom.world(NCLT_EXTENT, NCLT_SCANS,
                                                      cfg.tpu.scan_points)
    data = (scans, valids, np.zeros(valids.shape, np.float32))
    prof = filter_kernel_ms(filt, data, card, "config_nclt.yaml")
    del filt
    torch.cuda.empty_cache()
    calls = []
    for i, (where, level, per, c, n) in enumerate(INT8_CALLS):
        b = caps[level]
        nb = b - b // 10
        q8, nbr, w8, scale = gather_case(b, nb, c, n, seed=700 + i)
        check_gather(q8, nbr, w8, scale, f"NCLT {where} q8{tuple(q8.shape)} N={n}")
        ms = time_ms(lambda: bi8.brick_conv_int8_gather(q8, nbr, w8, scale, torch.bfloat16))
        plain_ms = time_ms(lambda: bi8.brick_conv_int8_gather_ref(q8, nbr, w8, scale,
                                                                  torch.bfloat16),
                           runs=3, warmup=1)
        ops, nbytes, bound_ms, bound_by = gather_bound(b, nb, c, n)
        calls.append(dict(call=where, level=f"L{level}", calls_per_scan=per, b=b, num_bricks=nb,
                          c=c, n=n, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, gop=ops / 1e9, gbytes=nbytes / 1e9))
        log(f"  time brick_conv_int8_gather NCLT {where:20s} L{level} B={b} ({nb} bricks) "
            f"{c}->{n} bf16 [{card}]: {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
            f"{bound_ms:.3f} ms ({bound_by})")
        del q8, nbr, w8, scale
        torch.cuda.empty_cache()
    scan_sums = {k: sum(c[k] * c["calls_per_scan"] for c in calls)
                 for k in ("ms", "plain_ms", "bound_ms")}
    log(f"  brick_conv_int8_gather at NCLT's capacities, a scan (10 calls) [{card}]: "
        f"{scan_sums['ms']:.3f} ms, bound {scan_sums['bound_ms']:.3f} ms, plain "
        f"{scan_sums['plain_ms']:.3f} ms")
    b3 = caps[3]
    q8, nbr, w8, scale = gather_case(b3, b3 - b3 // 10, 192, 64, seed=799)
    got = bk._int8_gather(q8, nbr, w8, scale, torch.bfloat16)
    want = bi8.brick_conv_int8_gather_ref(q8, nbr, w8, scale, torch.bfloat16)
    split_equal = torch.equal(got.view(torch.int16), want.view(torch.int16))
    log(f"  C = 192 at L3 B={b3}: {192 // bk.INT8_CHUNK} launches of {bk.INT8_CHUNK} channels "
        f"bit-equal to one launch's plain version: {split_equal}")
    if not split_equal:
        raise AssertionError("15c: the C = 192 split differs from the plain version")
    del q8, nbr, w8, scale, got, want
    torch.cuda.empty_cache()
    return {"summary": out, "p50": p50, "lat": lat, "peak": peak, "launches": launches,
            "topo_miss_points": [r["topo_miss_points"] for r in per_scan],
            "int8_by_level": by_level, "int8_by_shape": {str(k): v for k, v in by_shape.items()},
            "profile": prof, "calls": calls, "a_scan": scan_sums, "caps": list(caps)}


# Phase 16: the measurement tools at BLT scale, against sps_tpu's pins.
OCC_PIN = os.path.join(HERE, "sps_torch", "assets", "occupancy_pin.npz")
TOPO_PIN = os.path.join(HERE, "sps_torch", "assets", "topo_reuse_pin.npz")
PROFILE_SCANS = 8
PROFILE_TOP = 8


def pin_inputs(what, points, pin_valid, pin_sha):
    """Each scan's valid points against the pin's: their count and
    fingerprint (bench_world.fingerprint, the sha256 of the f32 bytes)."""
    from sps_torch.data.bench_world import fingerprint

    if ([len(p) for p in points] != list(pin_valid)
            or [fingerprint(p) for p in points] != list(pin_sha)):
        raise AssertionError(f"{what}: the scans differ from the pin's")


def phase_occupancy(card, shipped):
    """16a: measure_occupancy over bench_world's 24 scans against sps_tpu's
    pin; a scan's count may differ by its quantization moves."""
    from sps_torch.data import bench_world
    from sps_torch.scripts import measure_occupancy
    from sps_torch.scripts import measure_topo_reuse as mtr

    log("phase 16a: measure_occupancy at config.yaml as shipped (bench_world's 24 scans) "
        "against sps_tpu's pin")
    with np.load(OCC_PIN) as z:
        pin = {k: z[k] for k in z.files}
    meta = json.loads(str(pin["meta"]))
    t = time.time()
    stable, scans, _, valids = bench_world.make_data(shipped.tpu.scan_points, meta["scans"],
                                                     extent=meta["extent"])
    pts = [s[v] for s, v in zip(scans, valids)]
    pin_inputs("16a", pts, pin["valid"], pin["xyz_sha"])
    res = measure_occupancy.occupancy(shipped, stable, scans, valids,
                                      log=lambda m: log(f"  {m}"))
    moved = np.asarray([int(mtr.moved(p, shipped.voxel_size).sum()) for p in pts])
    diff = np.abs(res["num"] - pin["num"])
    log(f"  per-level max {res['max'].tolist()} (sps_tpu {pin['num'].max(0).tolist()}) / cap "
        f"{res['cap'].tolist()}; points the quantizations place apart a scan {moved.tolist()}; "
        f"largest |count - sps_tpu's| {diff.max()} (bound: the scan's moves); "
        f"{time.time() - t:.1f} s [{card}]")
    if res["overflow"].any() or pin["overflow"].any():
        raise AssertionError("16a: a level overflowed")
    if not np.array_equal(res["cap"], pin["cap"]) or (diff > moved[:, None]).any():
        raise AssertionError(f"16a: occupancy differs from sps_tpu's beyond the moves: {diff}")
    return dict(max=res["max"].tolist(), pin_max=pin["num"].max(0).tolist(),
                cap=res["cap"].tolist(), max_diff=int(diff.max()), moved=moved.tolist())


def phase_topo_reuse(card, shipped, sd):
    """16b: measure_topo_reuse at the pin's depth against sps_tpu's misses."""
    from sps_torch.data import bench_world
    from sps_torch.scripts import measure_topo_reuse as mtr

    log("phase 16b: measure_topo_reuse at config.yaml as shipped against sps_tpu's pin")
    with np.load(TOPO_PIN) as z:
        pin = {k: z[k] for k in z.files}
    meta = json.loads(str(pin["meta"]))
    steps, k, n = meta["steps"], meta["k"], meta["cut"]["scans"]
    t = time.time()
    stable = bench_world.make_data(shipped.tpu.scan_points, 24)[0]
    res = mtr.topo_reuse(shipped, sd, stable, steps, k, n)
    with open(os.path.join(HERE, "exp_results", "topo_reuse.json")) as f:
        jax_json = {e["step_m"]: e for e in json.load(f)["trajectories"]}
    out = {}
    for step, entry in zip(steps, res["trajectories"]):
        rows, pts = res["rows"][step], res["scans_xyz"][step]
        pin_inputs(f"16b {step} m", pts, pin[f"valid/{step}"], pin[f"xyz_sha/{step}"])
        miss = np.asarray([r[0] for r in rows])
        bound = np.asarray(mtr.quantization_bound(pts, k, shipped.voxel_size,
                                                  shipped.tpu.brick_side))
        diff = np.abs(miss - pin[f"miss/{step}"])
        j = jax_json[step]
        log(f"  {step} m a scan: misses {miss.tolist()}; |misses - sps_tpu's| {diff.tolist()} "
            f"(bounds {bound.tolist()}); mean {entry['miss_points_mean']:.1f} points "
            f"({100 * entry['miss_frac_mean']:.2f}%), max {entry['miss_points_max']} "
            f"({100 * entry['miss_frac_max']:.2f}%) over {entry['reuse_scans']} reuse scans; "
            f"exp_results/topo_reuse.json (sps_tpu, 24 scans): mean "
            f"{j['miss_points_mean']:.1f} ({100 * j['miss_frac_mean']:.2f}%), max "
            f"{j['miss_points_max']} ({100 * j['miss_frac_max']:.2f}%)")
        if (diff > bound).any():
            raise AssertionError(f"16b {step} m: misses beyond the quantization bound")
        out[step] = dict(entry, misses=miss.tolist(), max_diff=int(diff.max()),
                         bound=bound.tolist())
    log(f"  16b: {len(steps)} x {n} scans in {time.time() - t:.1f} s [{card}]")
    return out


def phase_stage_profile(card, shipped, sd):
    """16c: profile_stream at config.yaml as shipped and with CONV_MODE
    zband, on bench_world's first scan."""
    import torch

    from sps_torch.data import bench_world
    from sps_torch.scripts import profile_stream
    from sps_torch.stream.engine import StreamingFilter

    log(f"phase 16c: profile_stream, config.yaml as shipped and zband, {PROFILE_SCANS} scans "
        f"each and the fused program")
    stable, scans, _, valids = bench_world.make_data(shipped.tpu.scan_points, 24)
    out = {}
    for label, cfg in (("shipped", shipped),
                       ("zband", twin(shipped, conv_mode="zband", zband_levels=1, int8=False))):
        reset_counts()
        res = profile_stream.profile(cfg, sd, stable, scans[0], valids[0], n=PROFILE_SCANS,
                                     fused=True, kernel_table=PROFILE_TOP,
                                     log=lambda m: log(f"  {label}: {m} [{card}]"))
        launches = read_counts()
        calls = res["unet_calls"]
        zband = label == "zband"
        want = {"zband_conv": routes(wgmma_k5=calls if zband else 0),
                "zband_conv_fused": routes(wgmma=2 * calls if zband else 0),
                "brick_conv_int8": 0, "brick_conv_int8_gather": 0 if zband else 10 * calls}
        log(f"  {label}: {calls} UNet calls; launches {launches} (expected {want})")
        if launches != want:
            raise AssertionError(f"16c {label}: launches {launches}, expected {want}")
        with torch.inference_mode():
            filt = StreamingFilter(cfg, sd, stable)
            s, _, stats = filt(scans[0], valids[0], np.zeros(len(valids[0]), np.float32),
                               np.eye(4, dtype=np.float32))
            s = s.float().cpu().numpy()
        if not np.array_equal(s, res["scores"]) or bool(stats["overflow"]):
            raise AssertionError(f"16c {label}: the stages' scores differ from the filter's "
                                 f"rebuild (max {np.abs(s - res['scores']).max()})")
        v = valids[0]
        if not (np.isfinite(s).all() and (s[v] > 0).all() and s.max() <= 1):
            raise AssertionError(f"16c {label}: scores outside (0, 1]")
        total = sum(res["kernel_ms"].values())
        log(f"  {label} [{card}]: stage p50 ms " + ", ".join(
            f"{k} {v:.2f}" for k, v in res["p50_ms"].items()) + "; kernel ms a rebuild "
            + ", ".join(f"{k} {v:.3f} ({res['launches'][k]:.0f} launches)"
                        for k, v in res["kernel_ms"].items())
            + f", {total:.3f} in all; scores bit-equal to the filter's rebuild")
        out[label] = {k: res[k] for k in ("p50_ms", "min_ms", "first_ms", "kernel_ms",
                                           "launches", "top", "levels", "unet_calls")}
        out[label]["kernel_launches"] = launches
        del filt
        torch.cuda.empty_cache()
    return out


def phase_sp_traffic(card, shipped, sd):
    """16d: measure_sp_scaling at sp = 2 on one scan, both modes, and the
    analytic NCLT table."""
    from sps_torch.scripts import measure_sp_scaling as mss

    log("phase 16d: measure_sp_scaling at sp = 2 (one scan, all-gather and ghost; gloo "
        "ranks on the one card)")
    t = time.time()
    map_pts, sx, sv = mss.world(shipped)
    rows = mss.measured_rows(shipped, sd, map_pts, sx, sv, widths=(2,), timeout=600.0,
                             log=lambda m: log(f"  {m} [{card}]"))
    nclt = mss.analytic_nclt(os.path.join(HERE, "config", "config_nclt.yaml"))
    log(f"  the JAX script's tables, the port's numbers from this run [{card}]; sps_tpu's "
        f"HLO counts from exp_results/sp_scaling.json:")
    for line in mss.tables(rows, nclt, mss.reference_rows()):
        log(f"  {line}")
    for r in rows:
        log(f"  sp=2 {r['mode']} [{card}]: " + ", ".join(
            f"{k} {r[k]['count']} ({r[k]['bytes'] / 1e6:.2f} MB)"
            for k in ("all-gather", "all-to-all", "all-reduce"))
            + f"; {r['host_staged']} host copies; first call {r['first_call_s']} s; overflow "
            f"{r['overflow']}; ranks' scores equal {r['scores_equal']}")
        if r["overflow"] or not r["scores_equal"] or r["total_count"] <= 0:
            raise AssertionError(f"16d {r['mode']}: overflow, unequal ranks or no collective")
    log(f"  16d: {time.time() - t:.1f} s [{card}]")
    return rows


# Phase 17: the distance feature under STEM_ZBAND. Its weights' seed (two
# input channels: phase 6's state dict has a one-channel stem).
DIST_SEED = 17


def phase_dist_stem_zband(card, shipped, stable, data):
    """17: DIST_FEATURE + STEM_ZBAND. config.yaml as shipped with the distance
    feature (dist_cap 1.0, as config_loc_movers_v2.yaml) and STEM_ZBAND on
    phase 6's scans: one wgmma_k5_wide launch a scan at the L0 capacity's
    C = 48 stem shape, 10 int8 gather launches a scan, no overflow, scores
    finite in (0, 1] and within 0.05 of the same filter and weights with the
    halo stem; both filters' p50 and kernel ms a scan."""
    import torch

    from sps_torch.models import spsnet

    log("phase 17: DIST_FEATURE + STEM_ZBAND (config.yaml, two input channels)")
    dist = dataclasses.replace(shipped, dist_feature=True, dist_cap=1.0)
    scfg = dist.sps_config(1)
    if scfg.unet.in_channels != 2 or not scfg.dist_feature:
        raise AssertionError("17: the distance feature does not give two input channels")
    sd = spsnet.init_state_dict(scfg, seed=DIST_SEED)
    n_scans, b0 = len(data[0]), scfg.caps.bricks[0]
    out = {}
    for label, cfg in (("STEM_ZBAND", twin(dist, stem_zband=True)), ("halo stem", dist)):
        filt, run = drive(cfg, sd, stable, data)
        run["p50"] = check_run(run, data[1], cfg.tpu.topo_every, card,
                               f"DIST_FEATURE {label} filter")
        zband = n_scans if cfg.tpu.stem_zband else 0
        check_launches(run, {"zband_conv": routes(wgmma_k5_wide=zband),
                             "zband_conv_fused": routes(),
                             "brick_conv_int8": 0, "brick_conv_int8_gather": 10 * n_scans},
                       f"DIST_FEATURE {label} filter")
        want = {("zband_conv", "wgmma_k5_wide", (b0, 12, 12, 48), (5, 5, 48, 128)): zband}
        if run["shape_launches"] != {k: v for k, v in want.items() if v}:
            raise AssertionError(f"17 {label}: launches by shape {run['shape_launches']}")
        run["profile"] = filter_kernel_ms(filt, data, card, f"DIST_FEATURE {label}")
        out[label] = run
        del filt
        torch.cuda.empty_cache()
    vs = compare_runs(out["STEM_ZBAND"], out["halo stem"], data[1], dist.threshold, 0.05,
                      "DIST_FEATURE STEM_ZBAND filter vs the halo stem")
    log(f"  17: p50 {out['STEM_ZBAND']['p50']:.2f} ms (STEM_ZBAND) / "
        f"{out['halo stem']['p50']:.2f} ms (halo stem); kernels a scan "
        f"{out['STEM_ZBAND']['profile']['kernel_ms']:.2f} / "
        f"{out['halo stem']['profile']['kernel_ms']:.2f} ms [{card}]")
    return dict(vs_halo_stem=vs, **{label: dict(
        p50=r["p50"], peak=r["peak"], launches=r["launches"],
        shape_launches={"/".join(map(str, k)): v for k, v in r["shape_launches"].items()},
        kernel_ms_a_scan=r["profile"]["kernel_ms"], launches_a_scan=r["profile"]["launches"],
        zband_kernel_ms_a_scan=r["profile"]["zband_kernel_ms"])
        for label, r in out.items()})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from sps_torch import config
    from sps_torch.models import spsnet
    from sps_torch.ops import brick_conv_int8 as bi8
    from sps_torch.ops import zband_conv as zc

    profile = "--profile" in sys.argv[1:]
    log("phase 1: build")
    t0 = time.time()
    zc.build()
    log(f"  built/loaded {', '.join(os.path.relpath(p, HERE) for p in zc.SOURCES)} "
        f"in {time.time() - t0:.1f} s")
    kernel = None
    for line in zc.build_log.splitlines():
        entry = re.search(r"entry function '\S*?\d((?:zband_\w*?|brick_int8_\w*?)kernel)"
                          r"(?:I(\w*?)EEv)?", line)
        if entry:
            kernel = entry.group(1)
            log(f"  ptxas: {kernel}" + (f"<{entry.group(2)}>" if entry.group(2) else ""))
        elif "registers" in line or "spill" in line or "(C75" in line:
            # C75xx: ptxas serialized wgmma or injected waits (a slow kernel)
            log(f"  ptxas:   {line.strip()}")
            # The int8 gather form: at most 128 registers, no spill, no C75xx note.
            regs = re.search(r"Used (\d+) registers", line)
            if kernel == "brick_int8_gather_kernel" and (
                    "(C75" in line or (regs and int(regs.group(1)) > 128)
                    or re.search(r"[1-9]\d* bytes spill", line)):
                raise AssertionError(f"ptxas: {kernel} {line.strip()}")
    card = card_line()
    log(f"  card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    shipped = config.load(os.path.join(HERE, "config", "config.yaml"))
    scfg = shipped.sps_config(1)
    errs, per_call, k3_same_call, f32_calls, dist_stem = phase_kernels(card)
    int8_calls = phase_int8_kernel(card, scfg.caps.bricks)
    gather_calls = phase_int8_gather(card, scfg.caps.bricks)
    phase_parity()

    n_scans = 10
    t0 = time.time()
    stable, scans, labels, valids = blt_scale_scans(n_scans, shipped.tpu.scan_points)
    data = (scans, valids, labels)
    log(f"data: map {len(stable)} points, scan valid points "
        f"{[int(v.sum()) for v in valids]} ({time.time() - t0:.1f} s)")
    sd = spsnet.init_state_dict(scfg, seed=0)
    zband = phase_path(card, shipped, sd, stable, data, profile)
    k3_runs = phase_microbench(card, f32_calls[-1])
    k3 = k3_runs["bf16"]
    ship = phase_shipping(card, shipped, sd, stable, data, profile)
    loop = phase_loop(card, shipped, sd, stable, data)
    pin_scans = int(np.load(os.path.join(HERE, "sps_torch", "assets", "loc_movers_v2_pin.npz"))
                    ["scans"])
    movers_root = movers_data(pin_scans)
    try:
        trained = phase_trained(card, movers_root)
        baselines = phase_baselines(card, movers_root, profile)
        bl_train = phase_baseline_training(card, movers_root)
        workflow = phase_workflow(card, movers_root, bl_train["dir"])
        gate = phase_gate(card)
        predict_trained = phase_predict_trained(card, movers_root)
    finally:
        shutil.rmtree(movers_root, ignore_errors=True)
    predict_blt, replay = phase_predict_blt(card, shipped, sd, stable, data, profile)
    train_k = phase_train_kernels(card, shipped.sps_config().caps.bricks)
    pin = phase_train_pin(card)
    fitted = phase_train(card, shipped, stable, data)
    try:
        stem_z = phase_train_stem_zband(card, shipped, sd, stable, data, ship, fitted["root"])
    finally:
        shutil.rmtree(fitted["root"], ignore_errors=True)
    hash_small = phase_hash_small(card)
    parity = phase_engines_parity(card, shipped, sd, stable, data)
    engines = phase_engines_times(card, shipped, sd, stable, data, parity["gather_voxels"])
    zlevels, l12_calls = phase_zband_levels(card, shipped, sd, stable, data, zband, profile)
    forms = phase_atlas_forms(card, shipped, sd, stable, data)
    nccl1 = phase_one_rank_nccl(card, shipped, sd, stable, data)
    sp2 = phase_sp_ranks(card, shipped, sd, stable, data)
    dp2 = phase_dp_ranks(card, shipped, stable, data)
    nclt = phase_nclt(card)
    occupancy = phase_occupancy(card, shipped)
    topo_reuse = phase_topo_reuse(card, shipped, sd)
    stages = phase_stage_profile(card, shipped, sd)
    sp_traffic = phase_sp_traffic(card, shipped, sd)
    dist17 = phase_dist_stem_zband(card, shipped, stable, data)

    kernels = []
    for name in ("zband_conv", "zband_conv_fused"):
        calls = [c for c in per_call if c["name"] == name]
        total = {key: sum(c[key] for c in calls)
                 for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
        kernels.append({
            "name": name, "route": "cuda", "source": calls[0]["source"],
            "replaces": REPLACES[name],
            "launches": sum(zband["launches"][name].values()), "max_abs_err": errs[name],
            "ms": total["ms"], "plain_ms": total["plain_ms"],
            "bound_ms": total["bound_ms"], "bound_by": calls[0]["bound_by"],
            "library_ms": total["library_ms"],
            **({"train": {
                "grad_checks": train_k,
                "launches_10b_pin": {r: v["launches"] for r, v in pin.items()},
                "launches_10c_fit": fitted["fit"]["launches"][name],
                "launches_10d_fit": stem_z["fit"]["launches"][name],
                "launches_10d_filter": stem_z["filter"]["launches"][name],
                "stem_ms_10d": stem_z["stem_ms"]}} if name == "zband_conv" else {}),
            "calls": [{k: c[k] for k in ("call", "route", "source", "ms", "wmma_ms", "plain_ms",
                                         "library_ms", "bound_ms", "bound_by", "gflop",
                                         "gbytes")}
                      for c in calls],
            "launches_16c": stages["zband"]["kernel_launches"][name],
            **({"launches_13a": {f"zband_levels_{zl}": {"zband_conv": r["launches"]["zband_conv"],
                                                         "zband_conv_fused": r["launches"][
                                                             "zband_conv_fused"]}
                                 for zl, r in zlevels.items() if "launches" in r},
                "calls_13a": [{k: v for k, v in c.items() if k != "name"} for c in l12_calls],
                "max_abs_err_13a": max(c["max_abs_err"] for c in l12_calls),
                "launches_14b": {label: {r: rec["launches"]["zband_conv"]
                                         for r, rec in sp2[label].items()}
                                 for label in sp2}} if name == "zband_conv_fused" else {}),
        })
    # The f32 calls of the zband path (phase 4's f32 run: the stem and both
    # block8 convs a scan) on the 3xTF32 kernel: a scan's sums at the full
    # shapes, K3 listed beside.
    path_f32 = f32_calls[:3]
    kernels.append({
        "name": "zband_conv_f32", "route": "cuda", "source": route_source("wgmma_f32"),
        "replaces": REPLACES["zband_conv_f32"],
        "launches": sum(r["wgmma_f32"] for name, r in zband["f32_launches"].items()
                        if isinstance(r, dict)),
        "max_abs_err": errs["zband_conv_f32"],
        **{key: sum(c[key] for c in path_f32)
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")},
        "bound_by": path_f32[0]["bound_by"],
        "launches_by_name": {name: r["wgmma_f32"] for name, r in zband["f32_launches"].items()
                             if isinstance(r, dict)},
        "launches_k3_f32": k3_runs["f32"]["launches"],
        "calls": [{k: c[k] for k in ("name", "call", "route", "source", "ms", "wmma_ms",
                                     "plain_ms", "library_ms", "bound_ms", "bound_by",
                                     "bound_fma_ms", "bound_bytes_ms", "gflop", "gbytes",
                                     "max_abs_err")}
                  for c in f32_calls],
    })
    # The C = 48 stem of DIST_FEATURE (phase 2's full-width call), launched
    # on phase 17's path; its f32 call (wgmma_f32) beside it.
    kernels.append({
        "name": "zband_conv_dist_stem", "route": "cuda", "source": dist_stem["source"],
        "replaces": REPLACES["zband_conv"],
        "launches": dist17["STEM_ZBAND"]["launches"]["zband_conv"]["wgmma_k5_wide"],
        **{key: dist_stem[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms", "wmma_ms",
                                           "executed_floor_ms", "gflop", "gbytes")},
        "f32": {k: dist_stem["f32"][k] for k in ("route", "source", "ms", "wmma_ms", "plain_ms",
                                                 "library_ms", "bound_ms", "bound_by",
                                                 "bound_fma_ms", "max_abs_err")},
        "phase_17": dist17,
    })
    kc = k3["variants"]["kernel-conv"]
    times = {"ms": kc["ms"], "plain_ms": k3["plain_ms"],
             "library_ms": k3["variants"]["conv2d"]["ms"], "bound_ms": k3["bound_ms"],
             "bound_by": k3["bound_by"]}
    kernels.append({
        "name": "microbench_zmm", "route": "cuda", "source": route_source(k3["route"]),
        "replaces": REPLACES["microbench_zmm"], "launches": k3["launches"],
        "max_abs_err": kc["max_abs_err"], **times,
        "calls": [{"call": f"microbench kernel-conv k=3 hz{tuple(k3['hz'])} "
                           f"wz{tuple(k3['wz'])} {k3['dtype']}", "route": k3["route"],
                   "source": route_source(k3["route"]), **times,
                   "gflop": k3["gflop_band"], "gbytes": k3["gbytes"],
                   "phase2_ms": k3_same_call["ms"], "phase2_wmma_ms": k3_same_call["wmma_ms"]}],
    })
    # The ten int8 calls of a scan: per-scan sums of the per-call times. The
    # shipping path runs the gather form; the halo form (the halo-tensor input
    # contract, launched 0 times on the path) is timed beside it.
    def scan_sums(calls, keys):
        return {k: sum(c[k] * c["calls_per_scan"] for c in calls) for k in keys}

    def bound_by(calls):
        return max(("bytes", "operations"), key=lambda by: sum(
            c["bound_ms"] * c["calls_per_scan"] for c in calls if c["bound_by"] == by))

    g = scan_sums(gather_calls, ("ms", "plain_ms", "bound_ms", "halo_plus_halo_form_ms",
                                 "halo_form_ms", "halo_conv3d_bf16_ms"))
    h = scan_sums(int8_calls, ("ms", "plain_ms", "bound_ms", "conv3d_bf16_ms"))
    kernels.append({
        "name": "brick_conv_int8_gather", "route": "cuda",
        "source": os.path.relpath(bi8.SOURCE, HERE),
        "replaces": REPLACES["brick_conv_int8_gather"],
        "launches": ship["launches"]["brick_conv_int8_gather"], "max_abs_err": 0.0,
        "ms": g["ms"], "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"],
        "bound_by": bound_by(gather_calls), "library_ms": None,
        "halo_plus_halo_form_ms": g["halo_plus_halo_form_ms"],
        "halo_form_same_operands_ms": g["halo_form_ms"],
        "halo_conv3d_bf16_ms": g["halo_conv3d_bf16_ms"],
        "path_num_bricks": ship["num_bricks"],
        "brick_engine": {"launches_a_scan": BRICK_INT8_LAUNCHES,
                         "launches": engines["brick region INT8"]["launches"][
                             "brick_conv_int8_gather"],
                         "calls_bit_equal": engines["brick region INT8"]["int8_calls"]},
        "loop_launches": {k: r["launches"] for k, r in loop.items()},
        "sp_launches_14b": {label: {r: rec["int8_launches"] for r, rec in sp2[label].items()}
                            for label in sp2},
        "offline_launches": {**{f"gate_{k}": r["launches"] for k, r in gate.items()},
                             "predict_blt": predict_blt["launches"],
                             "replay": replay["launches"]},
        "launches_16c": stages["shipped"]["kernel_launches"]["brick_conv_int8_gather"],
        "nclt_15c": {"launches": nclt["launches"]["brick_conv_int8_gather"],
                     "launches_a_scan_by_level": nclt["int8_by_level"],
                     "bricks_caps": nclt["caps"], "calls": nclt["calls"], "a_scan": nclt["a_scan"],
                     "filter_kernel_ms_a_scan": nclt["profile"]["kernel_ms"],
                     "filter_launches_a_scan": nclt["profile"]["launches"],
                     "p50_ms": nclt["p50"], "peak_bytes": nclt["peak"]},
        "calls": gather_calls,
        "halo_form": {
            "name": "brick_conv_int8", "source": os.path.relpath(bi8.SOURCE, HERE),
            "replaces": REPLACES["brick_conv_int8"],
            "launches": ship["launches"]["brick_conv_int8"], "ms": h["ms"],
            "plain_ms": h["plain_ms"], "bound_ms": h["bound_ms"], "bound_by": bound_by(int8_calls),
            "library_ms": None, "conv3d_bf16_ms": h["conv3d_bf16_ms"], "calls": int8_calls},
    })
    log(f"paths [{card}]: zband p50 {zband['p50']:.2f} ms, peak {zband['peak'] / 2**30:.2f} GiB; "
        f"shipping p50 {ship['p50']:.2f} ms, peak {ship['peak'] / 2**30:.2f} GiB; loop p50 "
        f"{loop['refine']['p50']:.2f} ms (refine), {loop['norefine']['p50']:.2f} ms (no refine); "
        f"trained ATE 20220629 sps {trained['20220629/sps']['ate']:.4f} m, raw "
        f"{trained['20220629/raw']['ate']:.4f} m; baselines ATE 20220629 " + ", ".join(
            f"{m} {baselines['runs'][f'20220629/{m}']['ate']:.4f}" for m in BASELINE_FILTERS)
        + " m, p50 ms a scan " + ", ".join(
            f"{m} {baselines['runs'][f'20220629/{m}']['p50_ms']:.1f}" for m in BASELINE_FILTERS)
        + "; gate uIoU " + ", ".join(
            f"{k} {v['uiou']:.5f}" for k, v in gate.items())
        + f"; predict dIoU v1 {predict_trained['v1']['means']['dIoU']:.4f}, v2 "
        f"{predict_trained['v2']['means']['dIoU']:.4f}; BLT predict p50 {predict_blt['p50']:.2f} "
        f"ms, peak {predict_blt['peak'] / 2**30:.2f} GiB; replay p50 "
        f"{replay['summary']['p50_latency_s'] * 1e3:.2f} ms; train step p50 "
        f"{fitted['fit']['p50']:.1f} ms, peak {fitted['fit']['peak'] / 2**30:.2f} GiB, "
        f"{fitted['profile']['launches']:.0f} launches a step; STEM_ZBAND train step p50 "
        f"{stem_z['fit']['p50']:.1f} ms, peak {stem_z['fit']['peak'] / 2**30:.2f} GiB; filter "
        f"kernels a scan {stem_z['kernels_ms_a_scan']['STEM_ZBAND']:.2f} (STEM_ZBAND) / "
        f"{stem_z['kernels_ms_a_scan']['halo stem']:.2f} ms (halo stem); hash engines: 12a "
        f"scores within {hash_small['pin_max_dscore']:.2e} of sps_tpu's pin, 12b gather / brick "
        f"within {parity['gather']:.2e} / {parity['brick (side 8, region)']:.2e} of atlas, 12c "
        f"p50 " + ", ".join(f"{k} {v['p50']:.2f} ms ({v['syncs']:.0f} syncs, "
                            f"{v['profile']['kernel_ms']:.2f} ms of kernels)"
                            for k, v in engines.items())
        + "; 13a zband_levels 2 / 3 p50 " + " / ".join(
            f"{zlevels[zl]['p50']:.2f}" for zl in (2, 3)) + " ms; 13b card vs CPU " + ", ".join(
            f"{k} {v['max_dscore']:.2e}" for k, v in forms.items()) + ", filters vs aliased "
        + ", ".join(f"{k} {v['filter_vs_aliased']['max_dscore']:.2e}" for k, v in forms.items())
        + f"; 14a sp bit-equal {nccl1['sp_bit_equal']}, dp step within "
        f"{nccl1['dp_max_diff']:.2e}; 14b p50 rank 0 " + ", ".join(
            f"{k} {v[0]['p50']:.1f} ms" for k, v in sp2.items())
        + f"; 14c dp-2 step {dp2[0]['step_ms']:.1f} / {dp2[1]['step_ms']:.1f} ms, peak "
        f"{dp2[0]['peak'] / 2**30:.2f} / {dp2[1]['peak'] / 2**30:.2f} GiB; 15a baseline steps "
        + ", ".join(f"{k} {v['ms_a_step']:.1f} ms ({v['peak'] / 2**30:.2f} GiB)"
                    for k, v in bl_train["trained"].items())
        + ", ATE from the trained checkpoints " + ", ".join(
            f"{k} {v['ate']:.4f}" for k, v in bl_train["localization"].items())
        + f" m; 15b calibrated epsilon {workflow['calibrate_threshold']['epsilon']} (F1 "
        f"{workflow['calibrate_threshold']['f1']}), ATE-optimal {workflow['epsilon_ate']}; 15c "
        f"NCLT {nclt['summary']['map_points']} map points, no overflow, p50 {nclt['p50']:.2f} ms, "
        f"kernels {nclt['profile']['kernel_ms']:.2f} ms a scan, peak "
        f"{nclt['peak'] / 2**30:.2f} GiB, int8 gather {nclt['a_scan']['ms']:.3f} ms a scan "
        f"(bound {nclt['a_scan']['bound_ms']:.3f}); 16a max occupancy {occupancy['max']} / "
        f"{occupancy['cap']} (sps_tpu {occupancy['pin_max']}); 16b mean misses a reuse scan "
        + ", ".join(f"{k} m {v['miss_points_mean']:.0f} ({100 * v['miss_frac_mean']:.2f}%)"
                    for k, v in topo_reuse.items())
        + "; 16c kernel ms a rebuild by stage " + "; ".join(
            f"{label} " + " / ".join(f"{v:.2f}" for v in r["kernel_ms"].values())
            for label, r in stages.items())
        + " (vox / topo / unet); 16d sp=2 MB a scan " + ", ".join(
            f"{r['mode']} {r['total_bytes'] / 1e6:.1f}" for r in sp_traffic)
        + f"; 17 DIST_FEATURE p50 {dist17['STEM_ZBAND']['p50']:.2f} (STEM_ZBAND) / "
        f"{dist17['halo stem']['p50']:.2f} ms (halo stem), kernels a scan "
        f"{dist17['STEM_ZBAND']['kernel_ms_a_scan']:.2f} / "
        f"{dist17['halo stem']['kernel_ms_a_scan']:.2f} ms, max |dscore| "
        f"{dist17['vs_halo_stem']['max_dscore']:.2e}")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
