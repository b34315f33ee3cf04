#!/usr/bin/env python3
"""Export what the PyTorch port (sps_torch) needs from the JAX package and
its checkpoints: files the port reads without JAX, flax or orbax.

    JAX_PLATFORMS=cpu python scripts/export_torch_assets.py [--scans 20] [--only ckpt,loc,loop]

Writes, under sps_torch/assets/:
  ckpt_loc_movers_v2.npz          the round-5 checkpoint ckpt_loc_movers_v2/best
                                  (orbax), params and batch_stats flattened by
                                  tree path ("params/MinkUNet/.../kernel"), f32;
                                  sps_torch.convert.load_npz reads it;
  ckpt_loc_movers_v2.config.json  the checkpoint's best.config.json;
  loc_movers_v2_pin.npz           sps_tpu's own results (CPU) for the trained
                                  localization protocol of chip_smoke.py phase 8:
                                  the movers dataset (config/config_loc_movers.yaml's
                                  recipe, seed 0, all five sequences, the first
                                  --scans scans of each), config_loc_movers_v2.yaml
                                  at epsilon 0.99, run_localization with raw, sps
                                  and oracle, prior odom, init_noise 0.05, refine,
                                  seed 0, on 20220629 and 20220629_clean: per-scan
                                  poses, ATE and kept fractions per filter and
                                  sequence, and the scores and stats of
                                  20220629's first scan at its ground-truth pose;
  loop_tiny_pin.npz               sps_tpu's LocalizationLoop on the tiny world of
                                  tests/test_torch_loop.py (whose JAX program
                                  takes longer to compile than that test may
                                  run): per-scan poses, keeps and stats, with the
                                  port's seeded weights.

Runs on the CPU in a few minutes (--scans 20).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402

ASSETS = os.path.join(HERE, "sps_torch", "assets")
CKPT = os.path.join(HERE, "ckpt_loc_movers_v2", "best")
LOC_SEQS = ("20220629", "20220629_clean")
LOC_FILTERS = ("raw", "sps", "oracle")
LOC_EPS = 0.99  # calibration.json's epsilon_ate
LOC_PROTOCOL = dict(prior="odom", init_noise=0.05, refine=True, seed=0, icp_iters=12)
# tests/test_torch_loop.py's world and loop.
LOOP_WORLD = dict(sequences=("20220629",), scans_per_seq=4, seed=3, extent=10.0, n_rays=400,
                  ground_points=6000, n_stable=10)
LOOP_TPU = dict(engine="atlas", topo_every=4)
LOOP_NARROW = dict(init_dim=4, planes=(4, 8, 8, 8, 8, 8, 8, 4))
LOOP_SEED = 0


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def flat_tree(tree, prefix=""):
    """Nested dict of arrays -> {"a/b/c": f32 array}."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flat_tree(v, name))
        else:
            out[name] = np.asarray(v, np.float32)
    return out


def restore_variables():
    from sps_tpu.utils import checkpoint as ckpt

    r = ckpt.restore(CKPT)
    return {"params": r["params"], "batch_stats": r["batch_stats"]}


def export_checkpoint():
    variables = restore_variables()
    flat = flat_tree(variables)
    np.savez(os.path.join(ASSETS, "ckpt_loc_movers_v2.npz"), **flat)
    shutil.copyfile(CKPT + ".config.json", os.path.join(ASSETS, "ckpt_loc_movers_v2.config.json"))
    n = sum(v.size for k, v in flat.items() if k.startswith("params/"))
    log(f"checkpoint: {len(flat)} leaves, {n} parameters")


def movers_dataset(root, scans):
    from sps_tpu.data import synthetic as jsyn
    from sps_torch.data import synthetic as tsyn

    jsyn.generate_dense(root, scans_per_seq=scans, **tsyn.MOVERS)


def loc_config(root):
    from sps_tpu import config as cfg_mod

    cfg = cfg_mod.load(os.path.join(HERE, "config", "config_loc_movers_v2.yaml"), data_root=root)
    return dataclasses.replace(cfg, threshold=LOC_EPS)


def export_loc_pin(scans):
    import jax
    import jax.numpy as jnp

    from sps_tpu import register as reg
    from sps_tpu.data import blt
    from sps_tpu.stream.localize import run_localization

    root = tempfile.mkdtemp(prefix="movers_")
    try:
        movers_dataset(root, scans)
        cfg = loc_config(root)
        variables = restore_variables()
        out = {"scans": np.int64(scans), "epsilon": np.float64(LOC_EPS)}
        last = {}
        reg_jit = jax.jit(lambda vms, s, v, p: reg.register_pyramid(
            vms, s, v, p, iters=LOC_PROTOCOL["icp_iters"]))

        def reg_fn(vms, s, v, p):
            pose, stats = reg_jit(vms, s, v, p)
            last["pose"] = np.asarray(pose)
            return pose, stats

        cache = {"reg_fn": reg_fn, "reg_fn_w": None}
        for seq in LOC_SEQS:
            for mode in LOC_FILTERS:
                poses = []
                t = time.time()
                r = run_localization(cfg, variables, seq, mode, cache=cache,
                                     log=lambda _m: poses.append(last["pose"]), **LOC_PROTOCOL)
                key = f"{seq}/{mode}"
                out[key + "/poses"] = np.stack(poses)
                out[key + "/ate"] = np.float64(r["ate_rmse"])
                out[key + "/kept_frac_mean"] = np.float64(r["kept_frac_mean"])
                log(f"{key}: ATE {r['ate_rmse']:.4f} m, kept {r['kept_frac_mean']:.3f} "
                    f"({time.time() - t:.0f} s)")
        scans0, gt = blt.load_sequences_raw(root, [LOC_SEQS[0]])
        ns = cfg.tpu.scan_points
        n = min(len(scans0[0]), ns)
        sx = np.zeros((ns, 3), np.float32)
        sl = np.zeros(ns, np.float32)
        sv = np.zeros(ns, bool)
        sx[:n], sl[:n], sv[:n] = scans0[0][:n, :3], scans0[0][:n, 3], True
        filt = cache["sps"]
        scores, _, stats = filt(sx, sv, sl, gt[0].astype(np.float32))
        out["first_scan/scores"] = np.asarray(jnp.asarray(scores), np.float32)
        out["first_scan/valid"] = sv
        # The configuration's 32 x 32 x 8-brick window does not hold the
        # whole scan: sps_tpu flags overflow and drops the points outside.
        for k in ("overflow", "n_scan_voxels", "n_submap_voxels", "n_kept"):
            out[f"first_scan/{k}"] = np.int64(int(stats[k]))
        np.savez(os.path.join(ASSETS, "loc_movers_v2_pin.npz"), **out)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def flax_tree(sd):
    """SPSModel state_dict -> flax {"params", "batch_stats"} tree (numpy)."""
    tree = {"params": {}, "batch_stats": {}}
    for name, v in sd.items():
        *path, leaf = name.split(".")
        node = tree["batch_stats" if leaf in ("mean", "var") else "params"]
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v.numpy()
    return tree


def loop_config(mod):
    """config_small with LOOP_TPU and a MinkUNet narrowed to LOOP_NARROW, as
    an instance of `mod`'s Config."""
    cfg = mod.load(os.path.join(HERE, "config", "config_small.yaml"))
    cfg = dataclasses.replace(cfg, tpu=dataclasses.replace(cfg.tpu, **LOOP_TPU))

    class Narrow(type(cfg)):
        def sps_config(self, batch_size=None):
            s = super().sps_config(batch_size)
            return dataclasses.replace(s, unet=dataclasses.replace(s.unet, **LOOP_NARROW))

    return Narrow(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def loop_inputs(root):
    """(scans padded to SCAN_POINTS as (x, valid, labels), gt poses, map)."""
    from sps_tpu.data import blt
    from sps_tpu.data import synthetic as jsyn

    jsyn.generate(root, **LOOP_WORLD)
    scans, poses = blt.load_sequences_raw(root, list(LOOP_WORLD["sequences"]))
    return scans, poses, blt.load_map(root, "base_map.asc.npy")


def export_loop_pin():
    import jax

    from sps_torch import config as tcfg_mod
    from sps_tpu import config as jcfg_mod
    from sps_tpu.stream.loop import LocalizationLoop
    from sps_torch.models import spsnet as tsps

    root = tempfile.mkdtemp(prefix="loop_")
    try:
        scans, gt, mp = loop_inputs(root)
        cfg = loop_config(jcfg_mod)
        sd = tsps.init_state_dict(loop_config(tcfg_mod).sps_config(1), seed=LOOP_SEED)
        variables = jax.tree.map(np.asarray, flax_tree(sd))
        ns = cfg.tpu.scan_points
        out = {"weights_abs_sum": np.float64(sum(float(v.abs().sum()) for v in sd.values()))}
        for refine in (True, False):
            loop = LocalizationLoop(cfg, variables, mp, refine=refine)
            poses, keeps, inliers, n_kept = [], [], [], []
            t = time.time()
            for i, scan in enumerate(scans):
                n = min(len(scan), ns)
                sx = np.zeros((ns, 3), np.float32)
                sl = np.zeros(ns, np.float32)
                sv = np.zeros(ns, bool)
                sx[:n], sl[:n], sv[:n] = scan[:n, :3], scan[:n, 3], True
                prior = gt[i].astype(np.float32) if i <= 1 else None
                pose, keep, st = loop(sx, sv, sl, prior=prior)
                poses.append(np.asarray(pose))
                keeps.append(np.asarray(keep))
                inliers.append(int(st["inliers"]))
                n_kept.append(int(st["n_kept"]))
            tag = "refine" if refine else "norefine"
            out[f"{tag}/poses"] = np.stack(poses)
            out[f"{tag}/keep"] = np.stack(keeps)
            out[f"{tag}/inliers"] = np.asarray(inliers)
            out[f"{tag}/n_kept"] = np.asarray(n_kept)
            log(f"loop ({tag}): {time.time() - t:.0f} s, n_kept {n_kept}")
        np.savez_compressed(os.path.join(ASSETS, "loop_tiny_pin.npz"), **out)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scans", type=int, default=20,
                    help="scans per movers sequence for the localization pin (>= 20)")
    ap.add_argument("--only", default="ckpt,loc,loop",
                    help="comma-separated subset of ckpt, loc, loop")
    args = ap.parse_args(argv)
    os.makedirs(ASSETS, exist_ok=True)
    parts = set(args.only.split(","))
    if "ckpt" in parts:
        export_checkpoint()
    if "loop" in parts:
        export_loop_pin()
    if "loc" in parts:
        export_loc_pin(args.scans)


if __name__ == "__main__":
    main()
