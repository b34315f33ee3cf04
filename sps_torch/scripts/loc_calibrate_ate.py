"""Deployment-objective threshold calibration and the final localization
table (the port of scripts/loc_calibrate_ate.py):

    python -m sps_torch.scripts.loc_calibrate_ate -c config/config_loc_movers.yaml \\
        --data DIR -w build/ckpt_loc_movers/best.pt --baselines build/ckpt_baselines \\
        [--grid 0.3,0.5,0.7,0.84,0.9,0.95,0.992] [--val-seqs A,B] [--runs 2] \\
        [--init-noise 0.05] [--prior odom|cv] [--filters sps,mask,raw,...] \\
        [--out build/exp_results] [--device cpu]

Epsilon sweeps --grid on the mean localization ATE (sps, refine on) over
the val sequences (default: the config's VAL split plus '<val>_clean'
when that sequence exists); the minimizer is the ATE-optimal epsilon.
calibration.json beside the weights gets the sweep, that epsilon, its
robustness window (epsilon_robustness) and the protocol; the weights'
.config.json sidecar, when present, gets it as `threshold`. Then the
{runs x TEST sequences x filters} table runs with it (the baselines keep
the config's threshold): <out>/results.jsonl and <out>/summary.md. A
failed table entry is logged and skipped. Runs on the card unless
--device cpu.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import numpy as np


def epsilon_robustness(sweep, eps_ate, blowup=2.0):
    """The contiguous epsilon window around the deployed value whose ATE
    stays within `blowup` x the best, and the first grid point above it
    (None when the window reaches the grid's top)."""
    best = min(s["ate_rmse"] for s in sweep)
    pts = sorted(sweep, key=lambda s: s["epsilon"])
    ok = [s["ate_rmse"] <= blowup * best for s in pts]
    idx = [i for i, s in enumerate(pts) if s["epsilon"] == eps_ate]
    lo = hi = idx[0] if idx else ok.index(True)
    while lo > 0 and ok[lo - 1]:
        lo -= 1
    while hi + 1 < len(pts) and ok[hi + 1]:
        hi += 1
    cliff = pts[hi + 1]["epsilon"] if hi + 1 < len(pts) else None
    return {
        "window": [pts[lo]["epsilon"], pts[hi]["epsilon"]],
        "blowup_threshold": blowup,
        "first_cliff_above": cliff,
        "note": "ATE <= blowup x best inside window (measured grid points)",
    }


def log(m):
    print(f"[ate-cal {time.strftime('%H:%M:%S')}] {m}", flush=True)


def ate_sweep(cfg, state_dict, grid, vseqs, prior, init_noise, cache, device=None):
    """Mean ATE (sps, refine) over vseqs at each epsilon of grid."""
    from sps_torch.stream import localize as loc

    sweep = []
    for eps in grid:
        ates, kepts = [], []
        for vs in vseqs:
            r = loc.run_localization(cfg, state_dict, vs, "sps", seed=0, epsilon=eps,
                                     prior=prior, init_noise=init_noise, refine=True,
                                     cache=cache, log=lambda s: None, device=device)
            ates.append(r["ate_rmse"])
            kepts.append(r["kept_frac_mean"])
        sweep.append({"epsilon": eps, "ate_rmse": round(float(np.mean(ates)), 4),
                      "per_seq": {s: round(a, 4) for s, a in zip(vseqs, ates)},
                      "kept_frac": round(float(np.mean(kepts)), 3)})
        log(f"val {vseqs} eps={eps}: mean ATE {np.mean(ates):.3f} m "
            f"({['%.3f' % a for a in ates]}) kept {np.mean(kepts):.2f}")
    return sweep


def record_calibration(weights, sweep, eps_ate, protocol):
    """Write the sweep, eps_ate, its robustness and the protocol into
    calibration.json beside `weights` (keeping what it held), and eps_ate
    as the threshold of the weights' sidecar when there is one."""
    calpath = os.path.join(os.path.dirname(os.path.abspath(weights)), "calibration.json")
    cal = {}
    if os.path.exists(calpath):
        with open(calpath) as f:
            cal = json.load(f)
    cal["ate_sweep"] = sweep
    cal["epsilon_ate"] = eps_ate
    cal["epsilon_robustness"] = epsilon_robustness(sweep, eps_ate)
    cal["protocol"] = protocol
    with open(calpath, "w") as f:
        json.dump(cal, f)
    sidecar = os.path.abspath(weights) + ".config.json"
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            sc = json.load(f)
        sc["threshold"] = eps_ate
        with open(sidecar, "w") as f:
            json.dump(sc, f, indent=2)
    return calpath


def table_lines(results, seqs, flts) -> list[str]:
    """Mean ATE and kept share per (sequence, filter) over the runs."""
    lines = ["| sequence | filter | ATE-RMSE (m) | kept |", "|---|---|---|---|"]
    for seq in seqs:
        for flt in flts:
            rs = [r for r in results if r["seq"] == seq and r["filter"] == flt]
            if not rs:
                continue
            ate = float(np.mean([r["ate_rmse"] for r in rs]))
            kept = float(np.mean([r["kept_frac_mean"] for r in rs]))
            lines.append(f"| {seq} | {flt} | {ate:.3f} | {kept:.2f} |")
    return lines


def run_table(cfg, state_dict, seqs, flts, runs, out, baselines, cache, sps_epsilon=None,
              prior="odom", init_noise=0.05, device=None):
    """{runs x seqs x flts} run_localization calls (refine on; sps at
    sps_epsilon when given) written to <out>/results.jsonl (replaced); a
    failed call is logged and skipped. Returns the result rows."""
    from sps_torch.scripts.loc_experiment import json_row
    from sps_torch.stream import localize as loc

    os.makedirs(out, exist_ok=True)
    results = []
    with open(os.path.join(out, "results.jsonl"), "w") as f:
        for run in range(runs):
            for seq in seqs:
                for flt in flts:
                    t0 = time.time()
                    try:
                        r = loc.run_localization(
                            cfg, state_dict, seq, flt, seed=run, prior=prior,
                            init_noise=init_noise,
                            baseline_weights=os.path.abspath(baselines) if baselines else None,
                            epsilon=sps_epsilon if flt == "sps" else None, refine=True,
                            cache=cache, log=lambda s: None, device=device)
                    except Exception:
                        traceback.print_exc()
                        log(f"run {run} {seq} {flt} FAILED")
                        continue
                    r.update(run=run, seq=seq, filter=flt, wall_s=round(time.time() - t0, 1))
                    results.append(r)
                    f.write(json.dumps(json_row(r)) + "\n")
                    f.flush()
                    log(f"run {run} {seq} {flt}: ATE {r['ate_rmse']:.3f} m "
                        f"kept {r['kept_frac_mean']:.2f}")
    return results


def main(argv=None):
    from sps_torch import config as cfg_mod
    from sps_torch import convert
    from sps_torch.structs import resolve_device

    ap = argparse.ArgumentParser(description="ATE-optimal epsilon and the final table.")
    ap.add_argument("-c", "--config", default="./config/config_loc_movers.yaml")
    ap.add_argument("--data", default=None, help="dataset root (defaults to $DATA)")
    ap.add_argument("-w", "--weights", default="./build/ckpt_loc_movers/best.pt",
                    help="SPS weights (.pt, .npz or a reference .ckpt); calibration.json is "
                         "written beside them")
    ap.add_argument("--baselines", default="./build/ckpt_baselines",
                    help="directory of the baselines' <model>.pt or <model>.npz")
    ap.add_argument("--grid", default="0.3,0.5,0.7,0.84,0.9,0.95,0.992")
    ap.add_argument("--val-seqs", default=None,
                    help="csv val sequences for the sweep objective (mean ATE); default = "
                         "config val + '<val>_clean' when that sequence exists")
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--init-noise", type=float, default=0.05,
                    help="translation noise (m) on the pose prior")
    ap.add_argument("--prior", choices=["odom", "cv"], default="odom",
                    help="pose prior for both the sweep and the table")
    ap.add_argument("--filters", default="sps,mask,raw,mos4d,mapmos,lts,oracle")
    ap.add_argument("--out", default="./build/exp_results")
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' for the CPU")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    cfg = cfg_mod.load(args.config, data_root=args.data)
    sd = convert.load_weights(args.weights, cfg.sps_config(1))
    cache = {}
    if args.val_seqs:
        vseqs = [s.strip() for s in args.val_seqs.split(",")]
    else:
        vseqs = list(cfg.data.val)
        clean = cfg.data.val[0] + "_clean"
        if os.path.isdir(os.path.join(cfg.data.root, "sequence", clean)):
            vseqs.append(clean)
    log(f"sweep objective: mean ATE over {vseqs}")
    sweep = ate_sweep(cfg, sd, [float(x) for x in args.grid.split(",")], vseqs, args.prior,
                      args.init_noise, cache, args.device)
    best = min(sweep, key=lambda s: s["ate_rmse"])
    eps_ate = best["epsilon"]
    log(f"ATE-optimal epsilon on val: {eps_ate} (mean ATE {best['ate_rmse']})")
    record_calibration(args.weights, sweep, eps_ate, {
        "prior": args.prior, "init_noise": args.init_noise, "refine": True,
        "objective": f"mean ATE over {vseqs}", "weights": os.path.abspath(args.weights)})

    # The ATE-calibrated epsilon applies to the SPS filter only; the
    # baselines keep the config's threshold.
    seqs = list(cfg.data.test)
    flts = [f.strip() for f in args.filters.split(",")]
    results = run_table(cfg, sd, seqs, flts, args.runs, args.out, args.baselines, cache,
                        sps_epsilon=eps_ate, prior=args.prior, init_noise=args.init_noise,
                        device=args.device)
    lines = [
        f"SPS weights `{args.weights}`, epsilon calibrated on mean val localization ATE over "
        f"{vseqs} ({eps_ate}; sweep in calibration.json beside the weights). Runs: run r is "
        f"seed r, {args.init_noise} m init noise, prior {args.prior}. Baselines from "
        f"{args.baselines}.",
        "",
        *table_lines(results, seqs, flts),
    ]
    with open(os.path.join(args.out, "summary.md"), "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines))
    return {"epsilon_ate": eps_ate, "sweep": sweep, "results": results}


if __name__ == "__main__":
    main()
