"""Per-stage timing of the streaming filter's rebuild program (the port of
scripts/profile_stream.py):

    python -m sps_torch.scripts.profile_stream [--engine atlas|brick] [--brick-side N] \\
        [--conv-mode region|halo|zband] [--bricks csv] [--row-from N] [--zband-levels N] \\
        [--int8] [--fused] [--trace-dir DIR] [--scans N] [--kernel-table N] [--device cpu]

The rebuild program is StreamingFilter's three stage methods: stage 1
`stage_vox` (pose, voxelize, map overlap), stage 2 `stage_topo` (the
pyramid), stage 3 `stage_unet` (MinkUNet, devoxelize, sigmoid). On the
first scan of sps_torch.data.bench_world's 24 (the JAX script's data) it
runs each stage once, logs the occupied bricks or rows per level, then
times each stage --scans times on the host clock (the device synchronized
before the clock starts and before it is read; p50 and min), and reads the
kernel time and launches of each stage from one torch.profiler pass of
--scans rebuilds, under the ranges "sps.stage.vox" / "sps.stage.topo" /
"sps.stage.unet". --fused also times the whole rebuild program in one call
(StreamingFilter._rebuild); --kernel-table N prints each stage's N CUDA
kernels that take the most device time (in place of the JAX script's
--dump-hlo); --trace-dir writes the profiler pass as a chrome trace. The
configuration is config/config.yaml and the weights are
sps_torch.train.create_state's with seed 0, as the JAX script's. Runs on the
card unless --device cpu.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
STAGES = ("vox", "topo", "unet")
RANGES = {f"sps.stage.{s}": s for s in STAGES}


def log(msg):
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def configure(cfg, engine=None, brick_side=None, conv_mode=None, bricks=None, row_from=None,
              zband_levels=None, int8=False):
    """cfg with the JAX script's TPU overrides (None / False: as loaded)."""
    over = {k: v for k, v in dict(engine=engine, brick_side=brick_side, conv_mode=conv_mode,
                                  bricks=bricks, row_from=row_from,
                                  zband_levels=zband_levels).items() if v is not None}
    if int8:
        over["int8"] = True
    return dataclasses.replace(cfg, tpu=dataclasses.replace(cfg.tpu, **over)) if over else cfg


def stage_kernels(prof) -> dict:
    """Per stage, from a profiler's events: {"kernel_us", "launches",
    "kernels": {name: [device us, launches]}} over every range of the stage
    (the device events attached to the host ops inside it)."""
    out = {s: {"kernel_us": 0.0, "launches": 0, "kernels": {}} for s in STAGES}

    def walk(evt, rec):
        for k in evt.kernels:
            ent = rec["kernels"].setdefault(k.name, [0.0, 0])
            ent[0] += k.duration
            ent[1] += 1
            rec["kernel_us"] += k.duration
            rec["launches"] += 1
        for child in evt.cpu_children:
            walk(child, rec)

    for evt in prof.events():
        stage = RANGES.get(evt.name)
        if stage is not None and str(evt.device_type).endswith("CPU") and (
                evt.cpu_parent is None or evt.cpu_parent.name not in RANGES):
            walk(evt, out[stage])
    return out


def profile(cfg, state_dict, stable, scan, valid, n=8, fused=False, trace_dir=None,
            kernel_table=0, device=None, log=log) -> dict:
    """The three stages on one scan: {"levels": [(occupied, capacity,
    overflow)], "first_ms": {stage: ms}, "p50_ms" / "min_ms": {stage (and
    "fused"): ms}, "kernel_ms" / "launches": {stage: per rebuild},
    "top": {stage: [(name, ms, launches) per rebuild]}, "unet_calls": the
    stage-3 calls made, fused ones included (each launches the UNet's
    kernels once),
    "scores": stage 3's scores of the scan (numpy)}."""
    from sps_torch.scripts.measure_occupancy import level_counts
    from sps_torch.stream.engine import StreamingFilter
    from sps_torch.utils import profiling

    filt = StreamingFilter(cfg, state_dict, stable, device=device)
    dev = filt.device
    x = torch.as_tensor(scan, dtype=torch.float32, device=dev)[None]
    v = torch.as_tensor(valid, dtype=torch.bool, device=dev)[None]
    lab = torch.zeros(v.shape, dtype=torch.float32, device=dev)
    pose = torch.eye(4, device=dev)[None]
    calls = {"unet": 0}
    stage_unet = filt.stage_unet

    def unet(levels, vx):
        calls["unet"] += 1
        return stage_unet(levels, vx)

    filt.stage_unet = unet  # the fused calls' stage 3 counts too

    def sync():
        profiling.synchronize(x)  # x lies on the filter's device

    timer = profiling.StageTimer()
    out = {"first_ms": {}}
    with torch.inference_mode():
        sync()
        t = time.perf_counter()
        vx = filt.stage_vox(x, v, pose)
        profiling.synchronize(vx)
        out["first_ms"]["vox"] = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        levels, _ = filt.stage_topo(vx.grid)
        profiling.synchronize(levels)
        out["first_ms"]["topo"] = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        scores, _ = unet(levels, vx)
        profiling.synchronize(scores)
        out["first_ms"]["unet"] = (time.perf_counter() - t) * 1e3
        log("first calls: " + ", ".join(f"{s} {ms:.1f} ms" for s, ms in out["first_ms"].items()))
        if fused:
            t = time.perf_counter()
            profiling.synchronize(filt._rebuild(x, v, lab, pose))
            out["first_ms"]["fused"] = (time.perf_counter() - t) * 1e3
            log(f"first fused call: {out['first_ms']['fused']:.1f} ms")
        out["levels"] = level_counts(levels)
        log(f"bricks occupied at L0: {out['levels'][0][0]} / cap {out['levels'][0][1]}")
        for li, (num, cap, over) in enumerate(out["levels"]):
            kind = "rows" if hasattr(levels[li].grid, "num_rows") else "bricks"
            log(f"  L{li}: {kind} {num} / {cap} (overflow={over})")

        def timeit(name, fn):
            for _ in range(n):
                sync()
                res = {}
                with timer.stage(name, block_on=lambda: res["out"]):
                    res["out"] = fn()

        timeit("vox", lambda: filt.stage_vox(x, v, pose))
        timeit("topo", lambda: filt.stage_topo(vx.grid))
        timeit("unet", lambda: unet(levels, vx))
        if fused:
            timeit("fused", lambda: filt._rebuild(x, v, lab, pose))
        samples = timer.samples
        out["p50_ms"] = {k: statistics.median(s) * 1e3 for k, s in samples.items()}
        out["min_ms"] = {k: min(s) * 1e3 for k, s in samples.items()}
        for k in samples:
            log(f"{k:5s}: p50 {out['p50_ms'][k]:.2f} ms (min {out['min_ms'][k]:.2f})")

        sync()
        with profiling.device_trace(trace_dir) as prof:
            for _ in range(n):
                vx2 = filt.stage_vox(x, v, pose)
                unet(filt.stage_topo(vx2.grid)[0], vx2)
            sync()
    per = stage_kernels(prof)
    out["kernel_ms"] = {s: per[s]["kernel_us"] / n / 1e3 for s in STAGES}
    out["launches"] = {s: per[s]["launches"] / n for s in STAGES}
    out["top"] = {s: [(name, us / n / 1e3, cnt / n) for name, (us, cnt) in sorted(
        per[s]["kernels"].items(), key=lambda kv: -kv[1][0])[:kernel_table]] for s in STAGES}
    for s in STAGES:
        log(f"{s:5s}: kernels {out['kernel_ms'][s]:.3f} ms, {out['launches'][s]:.0f} launches "
            f"a rebuild ({n} rebuilds profiled)")
        for name, ms, cnt in out["top"][s]:
            log(f"    {ms:9.3f} ms x{cnt:5.0f}  {name[:100]}")
    if trace_dir:
        log(f"trace -> {os.path.join(trace_dir, 'trace.json')}")
    out["unet_calls"] = calls["unet"]
    out["scores"] = scores.float().cpu().numpy()
    return out


def main(argv=None):
    from sps_torch import config as cfg_mod
    from sps_torch import train
    from sps_torch.data import bench_world
    from sps_torch.structs import resolve_device

    ap = argparse.ArgumentParser(description="Per-stage timing of the streaming filter.")
    ap.add_argument("--trace-dir", default=None)
    ap.add_argument("--scans", type=int, default=8)
    ap.add_argument("--engine", default=None)
    ap.add_argument("--brick-side", type=int, default=None)
    ap.add_argument("--conv-mode", default=None)
    ap.add_argument("--bricks", default=None, help="csv per-level brick caps (batch budget)")
    ap.add_argument("--row-from", type=int, default=None)
    ap.add_argument("--zband-levels", type=int, default=None)
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--fused", action="store_true")
    ap.add_argument("--kernel-table", type=int, default=0,
                    help="print each stage's N CUDA kernels that take the most device time")
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' for the CPU")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    cfg = configure(cfg_mod.load(os.path.join(HERE, "config", "config.yaml")), args.engine,
                    args.brick_side, args.conv_mode,
                    tuple(int(x) for x in args.bricks.split(",")) if args.bricks else None,
                    args.row_from, args.zband_levels, args.int8)
    stable, scans, _, valids = bench_world.make_data(cfg.tpu.scan_points, 24)
    scfg = cfg.sps_config(1)
    log(f"engine={cfg.tpu.engine} side={scfg.brick_side} conv={scfg.unet.conv_mode} "
        f"caps={scfg.caps.bricks}")
    sd = train.create_state(cfg, 0, 1, args.device).model.state_dict()
    res = profile(cfg, sd, stable, scans[0], valids[0], n=args.scans, fused=args.fused,
                  trace_dir=args.trace_dir, kernel_table=args.kernel_table, device=args.device)
    print(json.dumps({k: res[k] for k in ("p50_ms", "min_ms", "kernel_ms", "launches",
                                           "levels")}))
    return res


if __name__ == "__main__":
    main()
