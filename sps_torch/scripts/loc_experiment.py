"""Localization experiment: {run x sequence x filter} -> ATE table
(the port of scripts/loc_experiment.py):

    python -m sps_torch.scripts.loc_experiment -c config/config_loc_movers_v2.yaml \\
        -w sps_torch/assets/ckpt_loc_movers_v2.npz --data DIR [-seq 20220629,...] \\
        [--filters sps,mask,raw,sps@0.5] [--runs 1] [--init-noise 0.0] [--epsilon E] \\
        [--baseline-weights DIR] [--prior odom|cv] [--refine/--no-refine] \\
        [--out build/exp_results] [--fresh] [--device cpu]

Each (run, sequence, filter) is one run_localization call (run r is seed r);
'sps@E' runs the sps filter at threshold E. One JSON line a call is appended
to <out>/results.jsonl (--fresh truncates it first), and <out>/summary.md
is rebuilt from every row of that file: a protocol header, then per
(prior, refine, sequence, filter) the mean and sample std (ddof 1) of the
ATE, its min..max, the number of runs and the mean kept share. Without -w
the SPS model takes the port's seeded weights (spsnet.init_state_dict).
Runs on the card unless --device cpu.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np


def parse_filter(spec: str) -> tuple[str, float | None]:
    """'sps@0.5' -> ('sps', 0.5); 'raw' -> ('raw', None)."""
    if "@" in spec:
        mode, e = spec.split("@", 1)
        return mode, float(e)
    return spec, None


def json_row(r: dict) -> dict:
    """A run_localization result with its arrays as lists (JSON-ready)."""
    return {k: v.tolist() if isinstance(v, np.ndarray) else v for k, v in r.items()}


def summary_lines(rows: list[dict]) -> list[str]:
    """The summary table of result rows (the JAX script's layout)."""
    def vals(key, default=None):
        vs = sorted({str(r.get(key, default)) for r in rows})
        return vs[0] if len(vs) == 1 else "{" + ",".join(vs) + "}"

    lines = [
        f"Protocol: init_noise={vals('init_noise', 0.0)} "
        f"refine={vals('refine', True)} icp_iters={vals('icp_iters', 12)} "
        f"weights={vals('weights', 'random-init')} "
        f"baseline_weights={vals('baseline_weights', 'random-init')}",
        "",
        "| prior | refine | sequence | filter | ATE-RMSE mean±std (m) | min..max | runs | kept |",
        "|---|---|---|---|---|---|---|---|",
    ]
    keys = []
    for r in rows:
        k = (r.get("prior", "cv"), r.get("refine", True), r["seq"], r["filter"])
        if k not in keys:
            keys.append(k)
    for pr, rf, seq, flt in keys:
        rs = [r for r in rows
              if r["seq"] == seq and r["filter"] == flt
              and r.get("prior", "cv") == pr and r.get("refine", True) == rf]
        a = np.asarray([r["ate_rmse"] for r in rs], np.float64)
        kept = float(np.mean([r["kept_frac_mean"] for r in rs]))
        std = a.std(ddof=1) if len(a) > 1 else 0.0
        lines.append(
            f"| {pr} | {'y' if rf else 'n'} | {seq} | {flt} "
            f"| {a.mean():.3f} ± {std:.3f} "
            f"| {a.min():.3f}..{a.max():.3f} | {len(a)} | {kept:.2f} |")
    return lines


def write_summary(out: str) -> list[str]:
    """Rebuild <out>/summary.md from every row of <out>/results.jsonl."""
    with open(os.path.join(out, "results.jsonl")) as f:
        rows = [json.loads(ln) for ln in f if ln.strip()]
    lines = summary_lines(rows)
    with open(os.path.join(out, "summary.md"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return lines


def main(argv=None):
    from sps_torch import config as cfg_mod
    from sps_torch import convert
    from sps_torch.models import spsnet
    from sps_torch.stream import localize as loc
    from sps_torch.structs import resolve_device

    ap = argparse.ArgumentParser(description="{run x sequence x filter} -> ATE table.")
    ap.add_argument("-c", "--config", default="./config/config.yaml")
    ap.add_argument("-w", "--weights", default=None)
    ap.add_argument("-seq", "--sequences", default=None, help="csv; default = config TEST split")
    ap.add_argument("--filters", default="sps,mask,raw",
                    help="csv of filter modes; 'sps@0.5' runs sps with that threshold")
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--data", default=None, help="dataset root (defaults to $DATA)")
    ap.add_argument("--init-noise", type=float, default=0.0)
    ap.add_argument("--epsilon", type=float, default=None, help="filter threshold override")
    ap.add_argument("--baseline-weights", default=None,
                    help="dir with the baselines' <model>.pt (train_baselines) or <model>.npz; "
                         "seeded random weights if absent")
    ap.add_argument("--prior", choices=["odom", "cv"], default="odom",
                    help="'odom': noisy ground truth every scan; 'cv': constant velocity "
                         "after two seeded scans")
    ap.add_argument("--refine", action=argparse.BooleanOptionalAction, default=True,
                    help="re-filter at the registered pose and register once more")
    ap.add_argument("--out", default="./build/exp_results")
    ap.add_argument("--fresh", action="store_true",
                    help="truncate <out>/results.jsonl first")
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' for the CPU")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    cfg = cfg_mod.load(args.config, data_root=args.data)
    if args.epsilon is not None:
        cfg = dataclasses.replace(cfg, threshold=args.epsilon)
    seqs = ([s.strip() for s in args.sequences.split(",")] if args.sequences
            else list(cfg.data.test))
    flts = [f.strip() for f in args.filters.split(",")]
    sd = (convert.load_weights(args.weights, cfg.sps_config(1)) if args.weights
          else spsnet.init_state_dict(cfg.sps_config(1)))

    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "results.jsonl")
    if args.fresh and os.path.exists(path):
        os.remove(path)
    cache = {}  # shared across {run x seq x filter}: maps and filters built once
    with open(path, "a") as f:
        for run in range(args.runs):
            for seq in seqs:
                for flt in flts:
                    t0 = time.time()
                    mode, eps = parse_filter(flt)
                    r = loc.run_localization(
                        cfg, sd, seq, mode, init_noise=args.init_noise, seed=run,
                        prior=args.prior, baseline_weights=args.baseline_weights,
                        epsilon=eps, refine=args.refine, cache=cache, device=args.device)
                    r["prior"] = args.prior
                    r["filter"] = flt
                    r.update(
                        run=run, seq=seq, wall_s=round(time.time() - t0, 1),
                        weights=os.path.abspath(args.weights) if args.weights else "random-init",
                        baseline_weights=(os.path.abspath(args.baseline_weights)
                                          if args.baseline_weights else "random-init"),
                        config=os.path.abspath(args.config))
                    f.write(json.dumps(json_row(r)) + "\n")
                    f.flush()
                    print(f"[exp] run {run} seq {seq} filter {flt}: ATE {r['ate_rmse']:.3f} m",
                          flush=True)
    lines = write_summary(args.out)
    print("\n".join(lines))
    return lines


if __name__ == "__main__":
    main()
