"""What spatial sharding (sp) moves per scan (the port of
scripts/measure_sp_scaling.py):

    python -m sps_torch.scripts.measure_sp_scaling [--widths 2,4] \\
        [--out exp_results/sp_scaling_torch.json] [--device cpu]

  * measured: for each sp width and each way of assembling a conv's source
    (the all-gather of the level, or the ghost exchange at sps_tpu's
    ghost_frac rule), one scan of the sp StreamingFilter on `width` ranks
    spawned by parallel/launch.py (gloo; on the card the ranks share it, as
    NCCL refuses two ranks on one card), reading parallel/comm.py's
    COLLECTIVES on every rank: the collectives entered and their output
    bytes. At BLT scale (SCAN_POINTS >= 65536) the scan is
    sps_torch.data.bench_world's first, else the first of a small dense
    world. Four ranks are the most one card holds at BLT scale.
  * analytic: per-conv assembly bytes at config_nclt.yaml's capacities,
    all-gather against ghost exchange (plain arithmetic, as sps_tpu's).

sps_tpu counted the collectives of its compiled program's HLO, where XLA
fuses and schedules them; the port counts each collective call its eager
program makes (the ghost ids' all-gather, the gloo staging's copies apart).
The two counts answer the same question differently, so sps_tpu's figures
(exp_results/sp_scaling.json) are printed beside the port's, not held
against them. Writes exp_results/sp_scaling_torch.json (--out) and the
two markdown tables of the JAX script. Runs on the card unless --device cpu.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SPS_TPU_RESULTS = os.path.join(HERE, "exp_results", "sp_scaling.json")


def log(m):
    print(f"[{time.strftime('%H:%M:%S')}] {m}", file=sys.stderr, flush=True)


def ghost_frac(n_sp: int) -> float:
    """sps_tpu's rule: ghost rows a shard are its slab's surface, roughly
    constant as the block shrinks, so the fraction of a block doubles with
    the shard count; sp = 2 needs half a block (the deep row levels'
    compaction order is not slab-contiguous)."""
    return max(0.5, 0.125 * n_sp)


def modes(n_sp: int):
    return (("all-gather", 0.0), ("ghost", ghost_frac(n_sp)))


def world(cfg):
    """(map points, scan (ns, 3), valid (ns,)): bench_world's first scan at
    BLT scale, else the first scan of sps_tpu's small dense sp world."""
    from sps_torch.data import bench_world, synthetic

    ns = cfg.tpu.scan_points
    if ns >= 65536:
        map_pts, scans, _, valids = bench_world.make_data(ns, 2)
        return map_pts, scans[0], valids[0]
    root = os.path.join(tempfile.gettempdir(), "sps_torch_sp_scaling_world")
    if not os.path.isdir(root):
        synthetic.generate_dense(root, sequences=("sp",), scans_per_seq=2, extent=12.0,
                                 n_stable=14, map_density=140.0, scan_density=9.0)
    map_pts = np.load(os.path.join(root, "maps", "base_map.asc.npy"))[:, :3]
    scan = np.load(os.path.join(root, "sequence", "sp", "scans", "000000.npy"))
    sx = np.zeros((ns, 3), np.float32)
    sv = np.zeros((ns,), bool)
    k = min(len(scan), ns)
    sx[:k], sv[:k] = scan[:k, :3], True
    return map_pts, sx, sv


def sp_rank(rank, world_size, cfg, state_dict, map_pts, sx, sv, device):
    """One rank: for each mode, the sp filter on one scan with the counters
    set to 0 just before the call and read just after."""
    import torch

    from sps_torch.parallel import comm
    from sps_torch.parallel import mesh as pm
    from sps_torch.stream.engine import StreamingFilter

    mesh = pm.make_mesh(world_size, "sp")
    eye = np.eye(4, dtype=np.float32)
    out = []
    for mode, frac in modes(world_size):
        filt = StreamingFilter(cfg, state_dict, map_pts, mesh=mesh, sp_ghost_frac=frac,
                               device=device)
        if filt.device.type == "cuda":
            torch.cuda.synchronize()
        comm.reset_counts()
        t = time.perf_counter()
        scores, _, stats = filt(sx, sv, np.zeros(len(sv), np.float32), eye)
        overflow = bool(stats["overflow"])  # waits for the scan
        dt = time.perf_counter() - t
        out.append(dict(mode=mode, ghost_frac=frac, call_s=dt, overflow=overflow,
                        collectives=copy.deepcopy(comm.COLLECTIVES),
                        host_staged=comm.HOST_STAGED["copies"],
                        scores_sum=float(scores.double().sum())))
        del filt
    return out


def measured_rows(cfg, state_dict, map_pts, sx, sv, widths=(2, 4), device=None,
                  timeout=900.0, log=log) -> list[dict]:
    """Rows of (sp width, mode): the ranks' collectives on one scan (rank
    0's counts; every rank enters the same collectives, which is checked),
    the first call's seconds on rank 0, overflow on any rank."""
    from sps_torch.parallel import launch

    rows = []
    for n_sp in widths:
        ranks = launch.spawn(sp_rank, n_sp, cfg, state_dict, map_pts, sx, sv, device,
                             backend="gloo", timeout=timeout)
        for mi, (mode, frac) in enumerate(modes(n_sp)):
            recs = [r[mi] for r in ranks]
            coll = recs[0]["collectives"]
            if any(r["collectives"] != coll for r in recs):
                raise AssertionError(f"sp={n_sp} {mode}: the ranks entered different "
                                     f"collectives: {[r['collectives'] for r in recs]}")
            row = {"n_sp": n_sp, "mode": mode, "ghost_frac": frac,
                   "first_call_s": round(recs[0]["call_s"], 3),
                   "overflow": any(r["overflow"] for r in recs), **coll,
                   "total_bytes": sum(v["bytes"] for v in coll.values()),
                   "total_count": sum(v["count"] for v in coll.values()),
                   "host_staged": recs[0]["host_staged"],
                   "scores_equal": len({r["scores_sum"] for r in recs}) == 1}
            rows.append(row)
            log(f"sp={n_sp} {mode}: {row['total_count']} collectives, "
                f"{row['total_bytes'] / 1e6:.2f} MB/scan, first call {row['first_call_s']} s, "
                f"overflow={row['overflow']}")
    return rows


def analytic_nclt(cfg_path: str) -> list[dict]:
    """Per-conv assembly bytes at NCLT capacities: all-gather vs ghost.

    Brick levels move (cap, bs, bs, bs*T*C) activations; row levels
    (cap, T*C). Ghost exchange moves ghost_cap = frac * block rows of the
    same row width REGARDLESS of sp width (the slab surface belongs to
    one neighbor pair), while all-gather moves the whole level every conv.
    """
    from sps_torch import config as cfg_mod

    cfg = cfg_mod.load(cfg_path, data_root="/tmp")
    sc = cfg.sps_config(batch_size=1)
    bs, T = sc.brick_side, 2
    # channel width seen by the (most expensive) block conv at each level
    width = {0: 8, 1: 16, 2: 32, 3: 64, 4: 64}
    rows = []
    for li in range(5):
        cap = (sc.caps.bricks[li] if li < sc.row_from
               else sc.caps.voxels[li])
        row_elems = (bs * bs * bs * T * width[li] if li < sc.row_from
                     else T * width[li])
        level_bytes = cap * row_elems * 2  # bf16
        for n_sp in (2, 4, 8):
            blk = cap // n_sp
            # surface rows per shard are ~constant in n_sp (see measured_rows)
            ghost_rows = int(0.125 * n_sp * blk)
            rows.append({
                "level": li, "rep": "brick" if li < sc.row_from else "row",
                "cap": cap, "n_sp": n_sp,
                "allgather_mb_per_conv": round(level_bytes / 1e6, 3),
                "ghost_mb_per_conv": round(ghost_rows * row_elems * 2 / 1e6, 3),
            })
    return rows


def tables(rows, nclt, reference=None) -> list[str]:
    """The JAX script's two markdown tables; `reference` (sps_tpu's
    measured rows) adds its HLO counts beside the port's."""
    ref = {(r["n_sp"], r["mode"]): r for r in (reference or [])}
    out = ["| sp | mode | collectives | MB/scan | first call s | overflow "
           "| sps_tpu HLO collectives | sps_tpu HLO MB |",
           "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        j = ref.get((r["n_sp"], r["mode"]))
        out.append(f"| {r['n_sp']} | {r['mode']} | {r['total_count']} "
                   f"| {r['total_bytes'] / 1e6:.2f} | {r['first_call_s']} | {r['overflow']} "
                   + (f"| {j['total_count']} | {j['total_bytes'] / 1e6:.2f} |" if j
                      else "| - | - |"))
    out += ["", "| level | rep | cap | all-gather MB/conv | ghost MB/conv (sp=8) |",
            "|---|---|---|---|---|"]
    for li in range(5):
        r8 = [r for r in nclt if r["level"] == li and r["n_sp"] == 8][0]
        out.append(f"| L{li} | {r8['rep']} | {r8['cap']} "
                   f"| {r8['allgather_mb_per_conv']} | {r8['ghost_mb_per_conv']} |")
    return out


def reference_rows():
    """sps_tpu's measured rows (exp_results/sp_scaling.json), or None."""
    if not os.path.exists(SPS_TPU_RESULTS):
        return None
    with open(SPS_TPU_RESULTS) as f:
        return json.load(f)["measured"]


def main(argv=None):
    from sps_torch import config as cfg_mod
    from sps_torch import train
    from sps_torch.structs import resolve_device

    ap = argparse.ArgumentParser(description="What sp moves per scan.")
    ap.add_argument("--widths", default="2,4")
    ap.add_argument("--out", default=os.path.join(HERE, "exp_results", "sp_scaling_torch.json"))
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' for the CPU")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    cfg = cfg_mod.load(os.path.join(HERE, "config", "config.yaml"))
    map_pts, sx, sv = world(cfg)
    # Seed 0, as the JAX script's; made on the CPU (the same weights on
    # either device) and handed to every rank.
    sd = train.create_state(cfg, 0, 1, "cpu").model.state_dict()
    rows = measured_rows(cfg, sd, map_pts, sx, sv,
                         tuple(int(w) for w in args.widths.split(",")), device=args.device)
    nclt = analytic_nclt(os.path.join(HERE, "config", "config_nclt.yaml"))
    out = {"measured": rows, "analytic_nclt": nclt,
           "note": ("measured: collective calls and output bytes of one scan of the sp "
                    "StreamingFilter per rank, counted by parallel/comm.py at "
                    "config.yaml; analytic: per-conv assembly "
                    "bytes at config_nclt capacities, bf16")}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    log(f"wrote {args.out}")
    print("\n".join(tables(rows, nclt, reference_rows())))
    return out


if __name__ == "__main__":
    main()
