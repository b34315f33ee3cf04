"""The localization-evidence pipeline in one process (the port of
scripts/loc_pipeline.py): train -> calibrate -> baselines -> table.

    python -m sps_torch.scripts.loc_pipeline -c config/config_loc_movers.yaml --data DIR \\
        [--epochs 60] [--ckpt-out build/ckpt_loc_movers] [--baselines-out build/ckpt_baselines] \\
        [--baseline-steps 300] [--runs 2] [--filters sps,mask,raw,mos4d,mapmos,lts,oracle] \\
        [--out build/exp_results] [--skip-train] [--resume-train] [--skip-baselines] \\
        [--device cpu]

  A. fit the SPS model on the config (--epochs), checkpoints under
     <ckpt-out>/train (--resume-train continues from its last.pt);
  B. copy its best.pt and sidecar to <ckpt-out>/best.pt (--skip-train reuses
     that file);
  C. calibrate epsilon by max F1 on every scan of the first VAL sequence
     (calibrate_threshold.calibrate), writing <ckpt-out>/calibration.json
     and the sidecar's threshold; its StreamingFilter is kept for E;
  D. train MOS4D (4-scan buffer), MapMOS (SUBMAP_POINTS map points) and
     LTS for --baseline-steps each at SCAN_POINTS points a scan into
     --baselines-out (train_baselines);
  E. {runs x TEST sequences x filters} run_localization (prior odom, 0.05 m
     init noise, refine) at the calibrated epsilon: <out>/results.jsonl and
     <out>/summary.md.

Each stage after B is fault-isolated as in the JAX script: its failure is
logged with its traceback and the pipeline goes on (C falls back to the
config's threshold, E to whatever baselines exist). That is the workflow's
own contract; nothing here moves work to another device. Runs on the card
unless --device cpu.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import time
import traceback


def log(m):
    print(f"[pipeline {time.strftime('%H:%M:%S')}] {m}", flush=True)


def main(argv=None):
    from sps_torch import config as cfg_mod
    from sps_torch import convert
    from sps_torch import train as tr
    from sps_torch.data import blt
    from sps_torch.scripts import calibrate_threshold as cal
    from sps_torch.scripts import train_baselines as tb
    from sps_torch.scripts.loc_calibrate_ate import run_table, table_lines
    from sps_torch.structs import resolve_device

    ap = argparse.ArgumentParser(description="train -> calibrate -> baselines -> table")
    ap.add_argument("-c", "--config", default="./config/config_loc_movers.yaml")
    ap.add_argument("--data", default=None, help="dataset root (defaults to $DATA)")
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--ckpt-out", default="./build/ckpt_loc_movers",
                    help="the snapshot: best.pt + sidecar + calibration.json")
    ap.add_argument("--baselines-out", default="./build/ckpt_baselines")
    ap.add_argument("--baseline-steps", type=int, default=300)
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--filters", default="sps,mask,raw,mos4d,mapmos,lts,oracle")
    ap.add_argument("--out", default="./build/exp_results")
    ap.add_argument("--skip-train", action="store_true", help="reuse <ckpt-out>/best.pt")
    ap.add_argument("--resume-train", action="store_true",
                    help="resume stage A from <ckpt-out>/train/last.pt")
    ap.add_argument("--skip-baselines", action="store_true")
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' for the CPU")
    args = ap.parse_args(argv)
    dev = args.device
    resolve_device(dev)

    cfg = cfg_mod.load(args.config, data_root=args.data)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, max_epoch=args.epochs))
    ckpt_out = os.path.abspath(args.ckpt_out)
    best_repo = os.path.join(ckpt_out, "best.pt")

    # ---- A/B: train + snapshot ----
    if args.skip_train and os.path.isfile(best_repo):
        log(f"skip-train: using {best_repo}")
    else:
        log(f"stage A: training {args.epochs} epochs on {cfg.data.root}")
        best = tr.fit(cfg, log_dir=os.path.join(ckpt_out, "train_logs"),
                      ckpt_dir=os.path.join(ckpt_out, "train"), resume=args.resume_train,
                      device=dev)
        os.makedirs(ckpt_out, exist_ok=True)
        shutil.copyfile(best, best_repo)
        shutil.copyfile(best + ".config.json", best_repo + ".config.json")
        log(f"stage B: snapshot -> {best_repo}")
    sd = convert.load_weights(best_repo, cfg.sps_config(1))

    # ---- C: threshold calibration on the val split ----
    cache = {}
    epsilon = cfg.threshold
    try:
        log(f"stage C: calibrating epsilon on {cfg.data.val[0]}")
        best_row, cache["sps"] = cal.calibrate(cfg, sd, device=dev)  # the filter E reuses
        with open(os.path.join(ckpt_out, "calibration.json"), "w") as f:
            json.dump(best_row, f)
        epsilon = best_row["epsilon"]
        log(f"stage C: epsilon={epsilon} F1={best_row['f1']}")
        sidecar = best_repo + ".config.json"
        with open(sidecar) as f:
            sc = json.load(f)
        sc["threshold"] = epsilon
        with open(sidecar, "w") as f:
            json.dump(sc, f, indent=2)
    except Exception:
        traceback.print_exc()
        log("stage C FAILED; continuing with the config's threshold")

    # ---- D: baseline training ----
    if not args.skip_baselines:
        try:
            log(f"stage D: training baselines ({args.baseline_steps} steps each)")
            scans_tr, poses_tr = blt.load_sequences_raw(cfg.data.root, cfg.data.train)
            map_pts = blt.load_map(cfg.data.root, cfg.data.map_file)
            os.makedirs(args.baselines_out, exist_ok=True)
            pps = cfg.tpu.scan_points
            tb.train_mos4d(cfg, scans_tr, poses_tr, True, args.baseline_steps, 4, pps,
                           args.baselines_out, 0, device=dev)
            tb.train_mapmos(cfg, scans_tr, poses_tr, map_pts, args.baseline_steps, pps,
                            cfg.tpu.submap_points, args.baselines_out, 0, device=dev)
            tb.train_lts(cfg, scans_tr, args.baseline_steps, args.baselines_out, 0, device=dev)
        except Exception:
            traceback.print_exc()
            log("stage D FAILED; the table uses whatever baseline checkpoints exist")

    # ---- E: the localization table ----
    log(f"stage E: experiment runs={args.runs} filters={args.filters} eps={epsilon}")
    cfg_e = dataclasses.replace(cfg, threshold=float(epsilon))
    seqs = list(cfg.data.test)
    flts = [f.strip() for f in args.filters.split(",")]
    results = run_table(cfg_e, sd, seqs, flts, args.runs, args.out, args.baselines_out, cache,
                        device=dev)
    lines = table_lines(results, seqs, flts)
    with open(os.path.join(args.out, "summary.md"), "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines))
    return {"epsilon": epsilon, "results": results}


if __name__ == "__main__":
    main()
