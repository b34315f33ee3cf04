#!/usr/bin/env python3
"""Export what the PyTorch port (sps_torch) needs from the JAX package and
its checkpoints: files the port reads without JAX, flax or orbax.

    JAX_PLATFORMS=cpu python scripts/export_torch_assets.py [--scans 20]
        [--only ckpt,loc,loop,ckpt_v1,parity,predict,train,baselines,loc_baselines,hash,
                sp,dp,baseline_train,nclt,occupancy,topo_reuse,shipping,zband_levels,
                dist_stream,measure_tools,halo,mapmos_engines,localize_soft,spsmodel,
                gather_stream,profile_stream,register,topology,int8_divergence]

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
                                  port's seeded weights;
  ckpt_loc_movers.npz             the movers checkpoint ckpt_loc_movers/best (v1),
  ckpt_loc_movers.config.json     flattened as the v2 one;
  int8_parity_pin.npz             sps_tpu's run of the gate of
                                  tests/test_int8_parity.py: six scans of 20220608
                                  generated alone with that test's generate_dense
                                  arguments, config_loc_movers.yaml, the v1
                                  checkpoint, epsilon 0.9, StreamingFilter three
                                  times (float, INT8, INT8 + HEAD_FOLD): per-scan
                                  scores and valid masks, and TP/FP/FN summed over
                                  the scans (score > eps against label > eps) with
                                  their uIoU TP / (TP + FN + FP), per run;
  predict_pin.npz                 sps_tpu's eval.predict_step over the first
                                  --scans scans of 20220629 of the movers dataset:
                                  v1 under config_loc_movers.yaml and v2 under
                                  config_loc_movers_v2.yaml (the distance
                                  feature): per-scan Loss/R2/dIoU/Precision/
                                  Recall/F1, overflow flags, and the scan rows'
                                  scores;
  train_step_pin.npz              sps_tpu.train.grad_step on a seeded small world
                                  (two scans of sps_torch.data.synthetic's world and
                                  its map, batch 2), f32, the atlas engine, CONV_MODE
                                  halo, augmentation off, MinkUNet14 narrowed to
                                  LOOP_NARROW, LR 1e-3 halved every step: per record
                                  (TRAIN_RECORDS: the MSE loss; with STEM_ZBAND; the
                                  BCE loss; STABLE_WEIGHT 2) the inputs and initial
                                  variables, the loss and r2 of the first step, every
                                  gradient leaf, the batch_stats after it, and the
                                  parameters after 1 (and, for mse and stem_zband,
                                  after 3) steps on the same batch; and `meta`, the
                                  configuration as JSON (train_meta), from which
                                  chip_smoke.py rebuilds it without this script;
  baselines_r5_{mos4d,mapmos,lts}.npz
                                  the round-5 baseline checkpoints
                                  ckpt_baselines_r5/<model> (orbax), params and
                                  batch_stats flattened as the v2 one, f32,
                                  compressed (+ <model>.config.json beside);
                                  sps_torch.convert.load_baseline_npz reads them;
  loc_baselines_pin.npz           sps_tpu's run_localization with mask, mos4d,
                                  mapmos and lts (baseline_weights
                                  ckpt_baselines_r5) under loc_movers_v2_pin.npz's
                                  protocol and data, one cache across the runs
                                  (sequence by sequence, filter by filter):
                                  per-scan poses, ATE and kept fraction per
                                  filter and sequence, and for MOS4D and MapMOS
                                  every filter call's pose and keep mask
                                  (np.packbits over SCAN_POINTS, with the
                                  scan's point count); and 20220629's first scan
                                  (cut to SCAN_POINTS) at its ground-truth pose:
                                  its world-frame points, MOS4D's logits (the
                                  scan alone in the 4-scan buffer) and keep,
                                  MapMOS's logits (counter 0) and keep, LTS's
                                  window scores and kept points; chip_smoke.py
                                  phase 11 and tests/test_torch_{lts,
                                  localize_baselines}.py read it;
  hash_engines_pin.npz            sps_tpu's gather engine and hash join on
                                  chip_smoke.py phase 3's small world (seed 3,
                                  two scans 0.2 m apart), config_small.yaml as
                                  shipped (ENGINE gather, JOIN_MODE hash),
                                  MinkUNet14 at full width with the port's
                                  seeded weights (seed 1), f32: the first
                                  scan's voxelize hash table (keys, rows) and
                                  point2voxel, the radius join's mask over the
                                  map and its dropped count for that scan, and
                                  StreamingFilter's scores and integer stats
                                  for both scans; `meta` holds the world and
                                  configuration as JSON (hash_meta), from which
                                  chip_smoke.py phase 12a rebuilds them;
  sp_scores_pin.npz               sps_tpu's single-device SPSModel scores on
                                  tests/test_spatial.py's slab world (sp_points),
                                  f32, MinkUNet14 narrowed, with the port's
                                  seeded weights (seed 0), for the aliased
                                  pyramid (row_from 3) and the all-brick one
                                  (SP_FORMS, sp_configs): what the spawned ranks
                                  of tests/test_torch_spatial.py are held to;
  dp_step_pin.npz                 sps_tpu's make_dp_train_step on a 2-device CPU
                                  mesh: the train pin's configuration and batch
                                  (two different samples, one a device), its
                                  initial variables, the loss and r2, the
                                  averaged gradients, and the batch_stats and
                                  parameters after the step.
  sp_step_pin.npz                 sps_tpu's grad_step(sp_axis="sp") under
                                  shard_map on 2 and 4 CPU devices, and its
                                  unsharded grad_step, on the sp step's
                                  configuration (sps_tpu's dry-run
                                  configuration at voxel 0.25, MinkUNet14
                                  narrowed, f32; sp_step_config) and batch
                                  (sp_step_inputs): its initial variables, and
                                  for each world the loss, r2, overflow, the
                                  gradients summed over sp and the batch_stats
                                  after the step (written with --only sp).
  baseline_train_pin.npz          one step of each trainer of
                                  scripts/train_baselines.py as it runs them
                                  (BT_META: config_loc.yaml at voxel 0.25, 64
                                  bricks a level, a tiny seeded dataset stored
                                  in the pin), from the port trainers' seeded
                                  weights, LTS at dropout 0, MOS4D also with
                                  level 0's occupancy in f32 (mos4d_f32): the
                                  batch, the loss, the batch_stats after the
                                  step, and of every gradient and parameter
                                  leaf after the step its max-abs, sum and sum
                                  of squares and PIN_SAMPLE evenly spaced
                                  entries;
  nclt_pin.npz                    sps_tpu's StreamingFilter over
                                  scripts/check_nclt_headroom.py's world at
                                  config_nclt.yaml, world and capacities cut
                                  for the CPU (NCLT_META lists each cut): the
                                  world and every scan's integer stats;
  occupancy_pin.npz               scripts/measure_occupancy.py's program
                                  (jax_occupancy) over bench.py's 24 scans at
                                  config.yaml as shipped: per scan and level the
                                  occupied bricks or rows and the overflow flag,
                                  the capacities, and each scan's valid points
                                  and fingerprint;
  topo_reuse_pin.npz              scripts/measure_topo_reuse.py's loop
                                  (jax_topo_reuse) at TOPO_META's cut: per step
                                  of 0.2 / 1.0 / 6.5 m, every scan's topology
                                  misses, valid points and fingerprint;
  shipping_pin.npz,               sps_tpu's StreamingFilter (write_stream_pin:
  zband_levels_stream_pin.npz,    per scan the scores, keep and stats) on the
  dist_stream_pin.npz             inputs of tests/test_torch_shipping.py (the
                                  shipping TPU options, three scans),
                                  tests/test_torch_zband_levels_stream.py
                                  (ZBAND_LEVELS 2 and 3, one rebuild scan each)
                                  and tests/test_torch_dist.py (the distance
                                  feature, three scans), which read them; each
                                  records its inputs (the test's constants and
                                  fingerprints of the map, scans, poses and
                                  weights: test_torch_stream.pin_record);
  measure_tools_pin.npz           jax_occupancy and jax_topo_reuse on
                                  tests/test_torch_measure_tools.py's world and
                                  trajectories, which that test reads, with its
                                  inputs recorded the same way;
  gather_stream_pin.npz           the same for tests/test_torch_gather_engine.py
                                  (config_small.yaml as shipped, two scans);
  spsmodel_pin.npz,               sps_tpu's SPSModel (spsmodel_arrays: scores and
  halo_pin.npz                    overflow) on the points and weights of
                                  tests/test_torch_gather_engine.py (gather),
                                  tests/test_torch_brick_engine.py (brick at
                                  sps_tpu's defaults), tests/test_torch_config.py
                                  (the default config) and tests/test_torch_halo.py
                                  (halo, int8 and head_fold off and on), which read
                                  them (records: test_torch_stream.model_record);
  mapmos_engines_pin.npz          sps_tpu's MapMOS logits on the brick and voxelize
                                  engines, read by
                                  tests/test_torch_mapmos_engines.py;
  localize_soft_pin.npz           sps_tpu's run_localization with sps-soft (per-scan
                                  poses, the result's entries), read by
                                  tests/test_torch_localize_soft.py;
  profile_stream_pin.npz          scripts/profile_stream.py's three sps_tpu stages
                                  (jax_profile_stages) on one scan, read by
                                  tests/test_torch_profile_stream.py;
  register_pin.npz                sps_tpu.register's maps (lut and probing),
                                  correspondences, distances, yaw search,
                                  registrations and pyramid on the world and
                                  cases() of tests/test_torch_register.py,
                                  which reads it;
  topology_pin.npz                sps_tpu's voxelize and build_levels on the
                                  points and capacities of
                                  tests/test_torch_topology.py, which reads it;
  int8_divergence_pin.npz         jitted sps_tpu's scores and, per call of its
                                  brick_conv_int8, the recorded input, codes,
                                  pre-round values and scales, on the two worlds
                                  of tests/test_torch_int8_divergence.py, which
                                  reads it.

The tests that read the older pins (chip_smoke.py reads several as well):
loop_tiny tests/test_torch_loop.py; loc_movers_v2 test_torch_assets.py;
int8_parity test_torch_int8_parity.py; predict test_torch_predict.py;
train_step test_torch_train_step.py; loc_baselines
test_torch_localize_baselines.py and test_torch_lts.py; hash_engines
test_torch_gather_engine.py; sp_scores and sp_step test_torch_spatial.py; dp_step
test_torch_dp.py; baseline_train test_torch_train_baselines.py; nclt
test_torch_nclt.py; occupancy and topo_reuse only chip_smoke.py.

Runs on the CPU: ckpt, loop, train, baselines, hash, sp, dp, baseline_train, nclt and
occupancy in a few minutes each, loc and topo_reuse ~10-15 min
(--scans 20), parity and predict several minutes each (bf16 on XLA:CPU is slow),
loc_baselines ~80 min (MOS4D in bf16 and MapMOS at 78k points on XLA:CPU), the
pins of the tests' own inputs (shipping through int8_divergence) 1-2 min each.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
# The dp pin runs sps_tpu's step on a 2-device CPU mesh, the sp step pin on 2
# and 4 devices (set before JAX starts).
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=4").strip()

import numpy as np  # noqa: E402

ASSETS = os.path.join(HERE, "sps_torch", "assets")
CKPT = os.path.join(HERE, "ckpt_loc_movers_v2", "best")
CKPT_V1 = os.path.join(HERE, "ckpt_loc_movers", "best")
LOC_SEQS = ("20220629", "20220629_clean")
LOC_FILTERS = ("raw", "sps", "oracle")
LOC_EPS = 0.99  # calibration.json's epsilon_ate
LOC_PROTOCOL = dict(prior="odom", init_noise=0.05, refine=True, seed=0, icp_iters=12)
BASELINES_DIR = os.path.join(HERE, "ckpt_baselines_r5")
BASELINES = ("mos4d", "mapmos", "lts")
LOC_BASELINE_FILTERS = ("mask", "mos4d", "mapmos", "lts")
# tests/test_torch_loop.py's world and loop.
LOOP_WORLD = dict(sequences=("20220629",), scans_per_seq=4, seed=3, extent=10.0, n_rays=400,
                  ground_points=6000, n_stable=10)
LOOP_TPU = dict(engine="atlas", topo_every=4)
LOOP_NARROW = dict(init_dim=4, planes=(4, 8, 8, 8, 8, 8, 8, 4))
LOOP_SEED = 0
# tests/test_int8_parity.py's gate: its world (sps_torch.data.synthetic.
# PARITY, a copy of that test's generate_dense arguments) and epsilon.
PARITY_EPS = 0.9
PARITY_RUNS = {"float": {}, "int8": dict(int8=True), "int8_head_fold": dict(int8=True,
                                                                             head_fold=True)}
PREDICT_SEQ = "20220629"
PREDICT_RUNS = {"v1": (CKPT_V1, "config_loc_movers.yaml"),
                "v2": (CKPT, "config_loc_movers_v2.yaml")}
PREDICT_METRICS = ("Loss", "R2", "dIoU", "Precision", "Recall", "F1")
# The train-step pin: a small world, the atlas engine in halo mode, f32.
TRAIN_WORLD = dict(seed=5, extent=4.0, n_stable=6, ground_points=3000)
TRAIN_TPU = dict(engine="atlas", brick_side=8, row_from=3, conv_mode="halo",
                 atlas_extent=(6, 6, 3), scan_points=2048, submap_points=2048,
                 bricks=(256, 128, 64, 64, 64), voxels=(4096, 2048, 1024, 512, 256),
                 join_mode="dense", join_extent=(64, 64, 32), bf16=False, int8=False,
                 head_fold=False, stem_zband=False)
TRAIN_HP = dict(lr=1e-3, lr_decay=0.5, lr_epoch=1, weight_decay=1e-4, batch_size=2,
                augmentation=False, loss="mse", stable_weight=1.0)
TRAIN_VOXEL = 0.25
# record -> (TPU overrides, TRAIN overrides, Adam steps pinned)
TRAIN_RECORDS = {"mse": ({}, {}, 3), "stem_zband": (dict(stem_zband=True), {}, 3),
                 "bce": ({}, dict(loss="bce"), 1), "stable_weight": ({}, dict(stable_weight=2.0), 1)}


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


def restore_variables(path=CKPT):
    from sps_tpu.utils import checkpoint as ckpt

    r = ckpt.restore(path)
    return {"params": r["params"], "batch_stats": r["batch_stats"]}


def export_checkpoint(path=CKPT, name="ckpt_loc_movers_v2"):
    variables = restore_variables(path)
    flat = flat_tree(variables)
    np.savez(os.path.join(ASSETS, name + ".npz"), **flat)
    shutil.copyfile(path + ".config.json", os.path.join(ASSETS, name + ".config.json"))
    n = sum(v.size for k, v in flat.items() if k.startswith("params/"))
    log(f"checkpoint {name}: {len(flat)} leaves, {n} parameters")


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


def export_baselines():
    """The round-5 baseline checkpoints -> baselines_r5_<model>.npz (+ config)."""
    for model in BASELINES:
        path = os.path.join(BASELINES_DIR, model)
        flat = flat_tree(restore_variables(path))
        name = f"baselines_r5_{model}"
        np.savez_compressed(os.path.join(ASSETS, name + ".npz"), **flat)
        shutil.copyfile(path + ".config.json", os.path.join(ASSETS, name + ".config.json"))
        n = sum(v.size for k, v in flat.items() if k.startswith("params/"))
        log(f"checkpoint {name}: {len(flat)} leaves, {n} parameters")


def export_loc_baselines_pin(scans):
    """sps_tpu's run_localization with the baseline filters (mask, mos4d,
    mapmos, lts; weights ckpt_baselines_r5) under loc_movers_v2_pin.npz's
    protocol, and each model's raw output on 20220629's first scan."""
    import jax
    import jax.numpy as jnp

    from sps_tpu import register as reg
    from sps_tpu.data import blt
    from sps_tpu.data import range_image as ri
    from sps_tpu.stream import baselines as bl
    from sps_tpu.stream.localize import _make_baseline_filter, run_localization
    from sps_tpu.utils.geometry import transform_points

    root = tempfile.mkdtemp(prefix="movers_")
    try:
        movers_dataset(root, scans)
        cfg = loc_config(root)
        out = {"scans": np.int64(scans), "epsilon": np.float64(LOC_EPS)}
        last = {}
        reg_jit = jax.jit(lambda vms, s, v, p: reg.register_pyramid(
            vms, s, v, p, iters=LOC_PROTOCOL["icp_iters"]))

        def reg_fn(vms, s, v, p):
            pose, stats = reg_jit(vms, s, v, p)
            last["pose"] = np.asarray(pose)
            return pose, stats

        # Every call of the MOS4D and MapMOS filters: the pose it was given
        # and the keep mask it returned (padded to SCAN_POINTS), in call order.
        calls = []
        for cls in (bl.MOS4DFilter, bl.MapMOSFilter):
            def recorded(self, scan_xyz, pose, _call=cls.__call__):
                keep = np.asarray(_call(self, scan_xyz, pose))
                calls.append((np.asarray(pose, np.float32), keep))
                return keep
            cls.__call__ = recorded
        ns = cfg.tpu.scan_points
        # One cache for every run, as the experiment driver shares it: the
        # filters (MapMOS's scan counter included) carry over from the
        # first sequence to the second.
        cache = {"reg_fn": reg_fn, "reg_fn_w": None}
        for seq in LOC_SEQS:
            for mode in LOC_BASELINE_FILTERS:
                poses = []
                calls.clear()
                t = time.time()
                r = run_localization(cfg, None, seq, mode, cache=cache,
                                     baseline_weights=BASELINES_DIR,
                                     log=lambda _m: poses.append(last["pose"]), **LOC_PROTOCOL)
                key = f"{seq}/{mode}"
                out[key + "/poses"] = np.stack(poses)
                out[key + "/ate"] = np.float64(r["ate_rmse"])
                out[key + "/kept_frac_mean"] = np.float64(r["kept_frac_mean"])
                if calls:
                    keeps = np.zeros((len(calls), ns), bool)
                    for i, (_, k) in enumerate(calls):
                        keeps[i, :len(k)] = k
                    out[key + "/call_poses"] = np.stack([p for p, _ in calls])
                    out[key + "/call_n"] = np.asarray([len(k) for _, k in calls])
                    out[key + "/call_keeps"] = np.packbits(keeps, axis=1)
                log(f"{key}: ATE {r['ate_rmse']:.4f} m, kept {r['kept_frac_mean']:.3f} "
                    f"({time.time() - t:.0f} s)")
        # 20220629's first scan at its ground-truth pose, through fresh
        # filters: the world-frame points, MOS4D's logits (the scan alone
        # in buffer slot 0), MapMOS's (counter 0), and LTS's window scores.
        scans0, gt = blt.load_sequences_raw(root, [LOC_SEQS[0]])
        mp = blt.load_map(root, cfg.data.map_file)
        ns = cfg.tpu.scan_points
        scan = scans0[0][:ns].astype(np.float32)
        pose = gt[0].astype(np.float32)
        out["first_scan/world"] = np.asarray(transform_points(jnp.asarray(scan[:, :3]),
                                                              jnp.asarray(pose)))
        out["first_scan/pose"] = pose
        for mode in ("mos4d", "mapmos"):
            filt = _make_baseline_filter(cfg, mode, mp, weights_dir=BASELINES_DIR)
            logits = {}
            fn = filt._fn
            filt._fn = lambda *a: logits.setdefault("v", fn(*a))
            keep = filt(scan[:, :3], pose)
            lg = logits["v"][0] if mode == "mos4d" else logits["v"]
            out[f"first_scan/{mode}/logits"] = np.asarray(lg, np.float32)[:len(scan)]
            out[f"first_scan/{mode}/keep"] = np.asarray(keep)
        filt = _make_baseline_filter(cfg, "lts", mp, weights_dir=BASELINES_DIR)
        wins, _ = ri.windows(ri.project(scan, filt.lidar), filt.lidar)
        out["first_scan/lts/scores"] = np.asarray(filt._fn(filt.variables, jnp.asarray(wins)),
                                                  np.float32)
        out["first_scan/lts/kept"] = filt(scan)
        np.savez_compressed(os.path.join(ASSETS, "loc_baselines_pin.npz"), **out)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def padded(scan, ns):
    """A scan (N, 4) -> (xyz, labels, valid) padded to ns rows."""
    n = min(len(scan), ns)
    sx = np.zeros((ns, 3), np.float32)
    sl = np.zeros(ns, np.float32)
    sv = np.zeros(ns, bool)
    sx[:n], sl[:n], sv[:n] = scan[:n, :3], scan[:n, 3], True
    return sx, sl, sv


def export_parity_pin():
    import jax.numpy as jnp

    from sps_tpu import config as cfg_mod
    from sps_tpu.data import blt
    from sps_tpu.data import synthetic as jsyn
    from sps_tpu.stream.engine import StreamingFilter
    from sps_torch.data import synthetic as tsyn

    root = tempfile.mkdtemp(prefix="parity_")
    try:
        jsyn.generate_dense(root, **tsyn.PARITY)
        base = cfg_mod.load(os.path.join(HERE, "config", "config_loc_movers.yaml"),
                            data_root=root)
        variables = restore_variables(CKPT_V1)
        scans, poses = blt.load_sequences_raw(root, list(tsyn.PARITY["sequences"]))
        mp = blt.load_map(root, base.data.map_file)
        ns = base.tpu.scan_points
        out = {"epsilon": np.float64(PARITY_EPS), "scans": np.int64(len(scans))}
        for run, opts in PARITY_RUNS.items():
            cfg = dataclasses.replace(base, tpu=dataclasses.replace(base.tpu, **opts))
            filt = StreamingFilter(cfg, variables, mp)
            t = time.time()
            tp = fp = fn = 0
            scores_all, valid_all = [], []
            for scan, pose in zip(scans, poses):
                sx, sl, sv = padded(scan, ns)
                scores, _, _ = filt(sx, sv, sl, pose.astype(np.float32))
                s = np.asarray(jnp.asarray(scores), np.float32)
                pred, true = s[sv] > PARITY_EPS, sl[sv] > PARITY_EPS
                tp += int((pred & true).sum())
                fp += int((pred & ~true).sum())
                fn += int((~pred & true).sum())
                scores_all.append(s)
                valid_all.append(sv)
            uiou = tp / max(tp + fn + fp, 1)
            out.update({f"{run}/scores": np.stack(scores_all), f"{run}/tp": np.int64(tp),
                        f"{run}/fp": np.int64(fp), f"{run}/fn": np.int64(fn),
                        f"{run}/uiou": np.float64(uiou)})
            out["valid"] = np.stack(valid_all)
            log(f"parity {run}: uIoU {uiou:.5f} (TP {tp}, FP {fp}, FN {fn}; "
                f"{time.time() - t:.0f} s)")
        np.savez_compressed(os.path.join(ASSETS, "int8_parity_pin.npz"), **out)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def export_predict_pin(scans):
    import jax.numpy as jnp

    from sps_tpu import config as cfg_mod
    from sps_tpu import register as reg
    from sps_tpu.data.blt import BLTDataModule
    from sps_tpu.eval import predict_step

    root = tempfile.mkdtemp(prefix="predict_")
    try:
        movers_dataset(root, scans)
        out = {"scans": np.int64(scans)}
        for tag, (ckpt_path, cfg_name) in PREDICT_RUNS.items():
            cfg = cfg_mod.load(os.path.join(HERE, "config", cfg_name), data_root=root)
            cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data,
                                                                    test=(PREDICT_SEQ,)))
            variables = restore_variables(ckpt_path)
            data = BLTDataModule(cfg, test=True)
            map_points = jnp.asarray(data.map_points)
            map_vm = (reg.build_voxel_map(np.asarray(data.map_points),
                                          voxel_size=4 * cfg.voxel_size)
                      if cfg.dist_feature else None)
            rows = {k: [] for k in PREDICT_METRICS + ("overflow",)}
            scores_all, valid_all = [], []
            t = time.time()
            ns = cfg.tpu.scan_points
            for batch in data.batches(data.test, 1, shuffle=False):
                hb = {k: jnp.asarray(v) for k, v in batch.items() if k != "indices"}
                scores, _, m = predict_step(variables, hb, map_points, map_vm, cfg=cfg)
                for k in rows:
                    rows[k].append(np.asarray(m[k]))
                scores_all.append(np.asarray(scores, np.float32)[:ns])
                valid_all.append(batch["valid"][0])
            for k, v in rows.items():
                out[f"{tag}/{k}"] = np.asarray(v)
            out[f"{tag}/scores"] = np.stack(scores_all)
            out[f"{tag}/valid"] = np.stack(valid_all)
            out[f"{tag}/threshold"] = np.float64(cfg.threshold)
            log(f"predict {tag}: " + ", ".join(
                f"{k} {np.mean(rows[k]):.4f}" for k in PREDICT_METRICS)
                + f", overflow {int(np.sum(rows['overflow']))} scans ({time.time() - t:.0f} s)")
        np.savez_compressed(os.path.join(ASSETS, "predict_pin.npz"), **out)
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


def train_meta() -> dict:
    """The train pin's configuration: config_small.yaml with these overrides."""
    return {"voxel_size": TRAIN_VOXEL, "tpu": TRAIN_TPU, "train": TRAIN_HP,
            "narrow": LOOP_NARROW, "records": TRAIN_RECORDS}


def train_config(mod, record="mse"):
    """config_small with TRAIN_TPU, TRAIN_HP and the record's overrides,
    voxel TRAIN_VOXEL and MinkUNet14 narrowed to LOOP_NARROW, as an
    instance of `mod`'s Config."""
    tpu, hp, _ = TRAIN_RECORDS[record]
    cfg = mod.load(os.path.join(HERE, "config", "config_small.yaml"))
    cfg = dataclasses.replace(cfg, voxel_size=TRAIN_VOXEL,
                              tpu=dataclasses.replace(cfg.tpu, **{**TRAIN_TPU, **tpu}),
                              train=dataclasses.replace(cfg.train, **{**TRAIN_HP, **hp}))

    class Narrow(type(cfg)):
        def sps_config(self, batch_size=None):
            s = super().sps_config(batch_size)
            return dataclasses.replace(s, unet=dataclasses.replace(s.unet, **LOOP_NARROW))

    return Narrow(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def train_inputs():
    """The pin's batch and map from sps_torch.data.synthetic's numpy world:
    two scans (labels 0 stable / 1 clutter) padded to SCAN_POINTS, and the
    stable world as the map."""
    from sps_torch.data import synthetic as tsyn

    rng = np.random.default_rng(TRAIN_WORLD["seed"])
    stable = tsyn.make_world(**TRAIN_WORLD)
    clutter = tsyn._boxes(rng, 3, 0.6 * TRAIN_WORLD["extent"]).astype(np.float32)
    ns = TRAIN_TPU["scan_points"]
    xyz = np.zeros((2, ns, 3), np.float32)
    label = np.zeros((2, ns), np.float32)
    valid = np.zeros((2, ns), bool)
    for b, pose in enumerate(([0.5, 0.0], [-0.5, 0.5])):
        pts, lab = tsyn.sample_scan(rng, stable, clutter, np.asarray(pose), n_rays=120,
                                    max_r=6.0)
        n = min(len(pts), ns)
        xyz[b, :n], label[b, :n], valid[b, :n] = pts[:n], lab[:n], True
    return {"xyz": xyz, "label": label, "valid": valid}, stable


def export_train_pin():
    import jax
    from flax import struct

    from sps_tpu import config as jcfg_mod
    from sps_tpu import train as tr

    class Recording(tr.TrainState):
        """TrainState that keeps the gradients of its last update."""

        grads: object = struct.field(default=None)

        def apply_gradients(self, *, grads, **kw):
            return super().apply_gradients(grads=grads, **kw).replace(grads=grads)

    batch, mp = train_inputs()
    out = {"map": mp, "meta": np.asarray(json.dumps(train_meta())),
           **{f"batch/{k}": v for k, v in batch.items()}}
    for record, (_, _, steps) in TRAIN_RECORDS.items():
        cfg = train_config(jcfg_mod, record)
        s0 = tr.create_state(cfg, jax.random.PRNGKey(0), steps_per_epoch=1)
        state = Recording.create(apply_fn=s0.apply_fn, params=s0.params,
                                 batch_stats=s0.batch_stats, tx=s0.tx,
                                 grads=jax.tree.map(np.zeros_like, s0.params))
        step = jax.jit(lambda st, b, m, k: tr.grad_step(st, b, m, k, cfg=cfg, augment=False))
        key = jax.random.PRNGKey(1)
        out[f"{record}/init"] = flat_tree({"params": s0.params, "batch_stats": s0.batch_stats})
        t = time.time()
        for i in range(steps):
            state, m = step(state, batch, mp, key)
            if i == 0:
                out[f"{record}/loss"] = np.float64(m["loss"])
                out[f"{record}/r2"] = np.float64(m["r2"])
                out[f"{record}/overflow"] = np.bool_(m["overflow"])
                out[f"{record}/grads"] = flat_tree(state.grads)
                out[f"{record}/batch_stats_1"] = flat_tree(state.batch_stats)
                out[f"{record}/params_1"] = flat_tree(state.params)
        if steps > 1:
            out[f"{record}/params_{steps}"] = flat_tree(state.params)
            out[f"{record}/batch_stats_{steps}"] = flat_tree(state.batch_stats)
        log(f"train pin {record}: loss {out[f'{record}/loss']:.6f}, r2 "
            f"{out[f'{record}/r2']:.6f}, overflow {bool(out[f'{record}/overflow'])} "
            f"({time.time() - t:.0f} s)")
    flat = {}
    for k, v in out.items():
        if isinstance(v, dict):
            flat.update({f"{k}/{leaf}": a for leaf, a in v.items()})
        else:
            flat[k] = v
    np.savez_compressed(os.path.join(ASSETS, "train_step_pin.npz"), **flat)


# chip_smoke.py phase 3's small world (sps_torch.data.synthetic), the scans
# padded to config_small.yaml's SCAN_POINTS, and phase 3's weight seed.
HASH_META = {"config": "config/config_small.yaml", "world": dict(seed=3, extent=10.0,
             n_stable=10, ground_points=6000), "rng_seed": 3, "clutter": [3, 8.0],
             "scans": 2, "step": 0.2, "n_rays": 400, "weights_seed": 1}


def hash_inputs(meta):
    """(map, scans (S, ns, 3), valids, labels) of the hash pin's world."""
    from sps_torch import config as tcfg_mod
    from sps_torch.data import synthetic as tsyn

    ns = tcfg_mod.load(os.path.join(HERE, meta["config"])).tpu.scan_points
    stable = tsyn.make_world(**meta["world"])
    rng = np.random.default_rng(meta["rng_seed"])
    clutter = tsyn._boxes(rng, *meta["clutter"]).astype(np.float32)
    scans = np.zeros((meta["scans"], ns, 3), np.float32)
    valids = np.zeros((meta["scans"], ns), bool)
    labels = np.zeros((meta["scans"], ns), np.float32)
    for i in range(meta["scans"]):
        pts, lab = tsyn.sample_scan(rng, stable, clutter, np.array([meta["step"] * i, 0.0]),
                                    n_rays=meta["n_rays"])
        k = min(len(pts), ns)
        scans[i, :k], valids[i, :k], labels[i, :k] = pts[:k], True, lab[:k]
    return stable, scans, valids, labels


def export_hash_pin():
    import jax
    import jax.numpy as jnp

    from sps_torch import config as tcfg_mod
    from sps_torch.models import spsnet as tsps
    from sps_tpu import config as jcfg_mod
    from sps_tpu.ops import radius as jrad
    from sps_tpu.ops import voxelize as jvox
    from sps_tpu.stream.engine import StreamingFilter

    meta = HASH_META
    path = os.path.join(HERE, meta["config"])
    cfg = jcfg_mod.load(path)
    sd = tsps.init_state_dict(tcfg_mod.load(path).sps_config(1), seed=meta["weights_seed"])
    stable, scans, valids, labels = hash_inputs(meta)
    vcap = cfg.sps_config(1).caps.voxels[0]
    n = scans.shape[1]
    t = time.time()

    @jax.jit
    def first_scan(x, v, mp):
        # The gather program's voxelize (the pose is the identity) and the
        # join, both quantizing under jit as the filter does.
        coords = jvox.quantize(x, cfg.voxel_size)
        grid, p2v, _ = jvox.voxelize(coords, jnp.zeros(n, jnp.int32), jnp.ones(n, jnp.int32), v,
                                     num_time=2, voxel_capacity=vcap)
        mask, dropped = jrad.radius_join(x, v, mp, jnp.ones(mp.shape[0], bool), cfg.voxel_size,
                                         cell_capacity=cfg.tpu.cell_capacity,
                                         max_per_cell=cfg.tpu.max_per_cell)
        return grid.table.keys, grid.table.rows, p2v, grid.num_voxels, mask, dropped

    keys, rows, p2v, nvox, mask, dropped = first_scan(jnp.asarray(scans[0]),
                                                      jnp.asarray(valids[0]), jnp.asarray(stable))
    out = {"meta": np.asarray(json.dumps(meta)), "voxel/keys": np.asarray(keys),
           "voxel/rows": np.asarray(rows), "voxel/p2v": np.asarray(p2v),
           "voxel/num_voxels": np.int64(nvox), "join/mask": np.asarray(mask),
           "join/dropped": np.int64(dropped)}
    filt = StreamingFilter(cfg, jax.tree.map(np.asarray, flax_tree(sd)), stable)
    pose = np.eye(4, dtype=np.float32)
    scores, stats = [], {k: [] for k in ("n_scan_voxels", "n_submap_voxels", "n_kept")}
    for i in range(meta["scans"]):
        sc, _, st = filt(scans[i], valids[i], labels[i], pose)
        if bool(st["overflow"]):
            raise AssertionError(f"hash pin scan {i}: overflow")
        scores.append(np.asarray(sc))
        for k in stats:
            stats[k].append(int(st[k]))
    out["scores"] = np.stack(scores)
    out.update({f"stats/{k}": np.asarray(v) for k, v in stats.items()})
    np.savez_compressed(os.path.join(ASSETS, "hash_engines_pin.npz"), **out)
    log(f"hash pin: {int(nvox)} voxels, join kept {int(np.asarray(mask).sum())} of "
        f"{len(stable)} map points (dropped {int(dropped)}), stats {stats} "
        f"({time.time() - t:.0f} s)")


# tests/test_spatial.py's slab world and the sp tests' model: MinkUNet14
# narrowed, the atlas engine with side-8 bricks, conv_mode region (the
# default), L0 capacity 1024 bricks (divisible by 2 and 4 ranks).
SP_CAPS = dict(points=2048, voxels=(1024, 512, 512, 256, 128), bricks=(1024, 512, 256, 256, 256))
SP_UNET = dict(in_channels=1, out_channels=1, init_dim=4, planes=(4, 8, 8, 8, 8, 8, 8, 4),
               num_time=2)
SP_ATLAS = dict(voxel_size=0.25, engine="atlas", brick_side=8, atlas_extent=(2, 24, 24, 24))
SP_FORMS = {"row_from3": 3, "all_brick": None}
SP_SEED = 13
SP_WEIGHTS_SEED = 0


def sp_points(seed=SP_SEED):
    """tests/test_spatial.py's _slab_batch: one jittered point per 2 m brick
    over a 22 x 22 x 2 lattice (968 bricks at side 8, voxel 0.25): (xyz,
    batch, t, label)."""
    rng = np.random.default_rng(seed)
    xs = np.arange(-22.0, 22.0, 2.0, dtype=np.float32)
    gx, gy, gz = np.meshgrid(xs, xs, np.asarray([0.0, 2.0], np.float32))
    n = gx.size
    base = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=-1)
    xyz = base + rng.uniform(0, 2.0, (n, 3)).astype(np.float32)
    return (xyz, np.zeros(n, np.int64), rng.integers(0, 2, size=n),
            rng.uniform(0, 1, size=n).astype(np.float32))


def sp_configs(row_from):
    """(sps_tpu's SPSConfig, the port's) of the sp model at `row_from`."""
    from sps_torch.models import spsnet as tsps
    from sps_torch.models.minkunet import MinkUNetConfig as TUNetConfig
    from sps_torch.structs import Capacities as TCaps
    from sps_tpu.models import spsnet as jsps
    from sps_tpu.models.minkunet import MinkUNetConfig as JUNetConfig
    from sps_tpu.structs import Capacities as JCaps

    return (jsps.SPSConfig(caps=JCaps(**SP_CAPS), unet=JUNetConfig(**SP_UNET), row_from=row_from,
                           **SP_ATLAS),
            tsps.SPSConfig(caps=TCaps(**SP_CAPS), unet=TUNetConfig(**SP_UNET), row_from=row_from,
                           **SP_ATLAS))


def export_sp_pin():
    import jax

    from sps_torch.models import spsnet as tsps
    from sps_tpu.models.spsnet import SPSModel
    from sps_tpu.structs import pad_point_batch

    out = {}
    pb = pad_point_batch(*sp_points(), SP_CAPS["points"])
    for form, row_from in SP_FORMS.items():
        t = time.time()
        jcfg, tcfg = sp_configs(row_from)
        sd = tsps.init_state_dict(tcfg, seed=SP_WEIGHTS_SEED)
        scores, aux = jax.jit(lambda v, b: SPSModel(jcfg).apply(v, b))(
            jax.tree.map(np.asarray, flax_tree(sd)), pb)
        out[f"{form}/scores"] = np.asarray(scores)
        out[f"{form}/overflow"] = np.asarray(aux["overflow"])
        log(f"sp pin {form}: overflow {out[f'{form}/overflow'].tolist()} "
            f"({time.time() - t:.0f} s)")
    np.savez_compressed(os.path.join(ASSETS, "sp_scores_pin.npz"), **out)


# The sp training step: sps_tpu's dry-run configuration (parallel/mesh.py
# dryrun: atlas, side 8, halo convs, row levels from L3; L0 capacity 512
# bricks, divisible by 2 and 4 ranks) at voxel 0.25, MinkUNet14 narrowed.
SP_STEP_TPU = dict(scan_points=256, submap_points=256, cell_capacity=1024,
                   voxels=(1024, 512, 256, 256, 256), bricks=(512, 256, 256, 256, 256),
                   engine="atlas", brick_side=8, atlas_extent=(24, 24, 24), conv_mode="halo",
                   row_from=3)
SP_STEP_VOXEL = 0.25
SP_STEP_WORLDS = (1, 2, 4)


def sp_step_meta() -> dict:
    return {"voxel_size": SP_STEP_VOXEL, "tpu": SP_STEP_TPU, "narrow": LOOP_NARROW,
            "worlds": SP_STEP_WORLDS}


def sp_step_config(mod):
    """The sp step's configuration as an instance of `mod`'s Config."""
    cfg = mod.Config(data=mod.DataConfig(root="/tmp"), train=mod.TrainConfig(batch_size=1, lr=1e-3),
                     tpu=mod.TPUConfig(**SP_STEP_TPU), voxel_size=SP_STEP_VOXEL)

    class Narrow(type(cfg)):
        def sps_config(self, batch_size=None):
            s = super().sps_config(batch_size)
            return dataclasses.replace(s, unet=dataclasses.replace(s.unet, **LOOP_NARROW))

    return Narrow(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def sp_step_inputs():
    """One sample of uniform points in a 10 m cube with uniform labels, and a
    uniform map (numpy)."""
    rnp = np.random.default_rng(2)
    ns = SP_STEP_TPU["scan_points"]
    batch = {"xyz": rnp.uniform(-5, 5, (1, ns, 3)).astype(np.float32),
             "label": rnp.uniform(0, 1, (1, ns)).astype(np.float32),
             "valid": np.ones((1, ns), bool)}
    return batch, np.random.default_rng(3).uniform(-5, 5, (2048, 3)).astype(np.float32)


def export_sp_step_pin():
    import jax
    from flax import struct
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from sps_tpu import config as jcfg_mod
    from sps_tpu import train as tr
    from sps_tpu.parallel.mesh import shard_map

    class Recording(tr.TrainState):
        """TrainState that keeps the gradients of its last update."""

        grads: object = struct.field(default=None)

        def apply_gradients(self, *, grads, **kw):
            return super().apply_gradients(grads=grads, **kw).replace(grads=grads)

    t = time.time()
    batch, mp = sp_step_inputs()
    cfg = sp_step_config(jcfg_mod)
    s0 = tr.create_state(cfg, jax.random.PRNGKey(0), steps_per_epoch=1)
    out = {"map": mp, "meta": np.asarray(json.dumps(sp_step_meta())),
           **{f"batch/{k}": v for k, v in batch.items()},
           **{f"init/{k}": np.asarray(v) for k, v in
              flat_tree({"params": s0.params, "batch_stats": s0.batch_stats}).items()}}
    key = jax.random.PRNGKey(1)
    for n in SP_STEP_WORLDS:
        state = Recording.create(apply_fn=s0.apply_fn, params=s0.params,
                                 batch_stats=s0.batch_stats, tx=s0.tx,
                                 grads=jax.tree.map(np.zeros_like, s0.params))
        sp_axis = "sp" if n > 1 else None

        def local(st, b, m, k, sp_axis=sp_axis):
            return tr.grad_step(st, b, m, k, cfg=cfg, augment=False, sp_axis=sp_axis)

        if n > 1:
            local = shard_map(local, mesh=Mesh(np.asarray(jax.devices()[:n]), ("sp",)),
                              in_specs=(P(), P(), P(), P()), out_specs=(P(), P()),
                              check_rep=False)
        state, m = jax.jit(local)(state, batch, mp, key)
        out.update({f"{n}/loss": np.float64(m["loss"]), f"{n}/r2": np.float64(m["r2"]),
                    f"{n}/overflow": np.bool_(m["overflow"])})
        for prefix, tree in (("grads", flat_tree(state.grads)),
                             ("batch_stats_1", flat_tree(state.batch_stats))):
            out.update({f"{n}/{prefix}/{leaf}": np.asarray(a) for leaf, a in tree.items()})
        log(f"sp step pin, {n} device(s): loss {out[f'{n}/loss']:.6f}, overflow "
            f"{bool(out[f'{n}/overflow'])}")
    np.savez_compressed(os.path.join(ASSETS, "sp_step_pin.npz"), **out)
    log(f"sp step pin ({time.time() - t:.0f} s)")


def export_dp_pin():
    import jax
    from flax import struct
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from sps_tpu import config as jcfg_mod
    from sps_tpu import train as tr
    from sps_tpu.parallel import mesh as pm

    class Recording(tr.TrainState):
        """TrainState that keeps the gradients of its last update."""

        grads: object = struct.field(default=None)

        def apply_gradients(self, *, grads, **kw):
            return super().apply_gradients(grads=grads, **kw).replace(grads=grads)

    t = time.time()
    batch, mp = train_inputs()
    cfg = train_config(jcfg_mod)
    s0 = tr.create_state(cfg, jax.random.PRNGKey(0), steps_per_epoch=1)
    mesh = pm.make_mesh(2)
    rep, shard = NamedSharding(mesh, P()), NamedSharding(mesh, P("dp"))
    state = jax.device_put(Recording.create(apply_fn=s0.apply_fn, params=s0.params,
                                            batch_stats=s0.batch_stats, tx=s0.tx,
                                            grads=jax.tree.map(np.zeros_like, s0.params)), rep)
    step = pm.make_dp_train_step(cfg, mesh, augment=False)
    init = flat_tree({"params": s0.params, "batch_stats": s0.batch_stats})
    state, m = step(state, {k: jax.device_put(v, shard) for k, v in batch.items()},
                    jax.device_put(mp, rep),
                    jax.device_put(jax.random.split(jax.random.PRNGKey(1), 2), shard))
    out = {"map": mp, "meta": np.asarray(json.dumps(train_meta())),
           **{f"batch/{k}": v for k, v in batch.items()},
           "loss": np.float64(m["loss"]), "r2": np.float64(m["r2"]),
           "overflow": np.bool_(m["overflow"])}
    for prefix, tree in (("init", init), ("grads", flat_tree(state.grads)),
                         ("batch_stats_1", flat_tree(state.batch_stats)),
                         ("params_1", flat_tree(state.params))):
        out.update({f"{prefix}/{leaf}": np.asarray(a) for leaf, a in tree.items()})
    np.savez_compressed(os.path.join(ASSETS, "dp_step_pin.npz"), **out)
    log(f"dp pin: loss {out['loss']:.6f}, r2 {out['r2']:.6f}, overflow {bool(out['overflow'])} "
        f"({time.time() - t:.0f} s)")


# The baseline trainers' pin: config_loc.yaml (scripts/train_baselines.py's
# default) at voxel 0.25 with the level capacities cut to 64 bricks, a tiny
# seeded dataset (sps_torch.data.synthetic; six scans in the sensor frame with
# yawed poses, the stable world as the map), one step of each trainer.
BT_META = {"config": "config/config_loc.yaml", "voxel_size": 0.25,
           "caps": dict(points=1024, voxels=[1024, 512, 256, 256, 256], bricks=[64] * 5),
           "world": dict(seed=21, extent=4.0, n_stable=6, ground_points=3000),
           "clutter": [3, 2.4], "scans": 6, "n_rays": 60, "max_r": 6.0,
           "n_scans": 2, "ns": 256, "nm": 512, "seed": 0, "steps": 1, "lts_dropout": 0.0}


def baseline_train_inputs(meta=BT_META):
    """The pin's dataset: (scans [x, y, z, label] in the sensor frame, 4x4
    poses, map points)."""
    from sps_torch.data import synthetic as tsyn

    rng = np.random.default_rng(meta["world"]["seed"])
    stable = tsyn.make_world(**meta["world"])
    n, ext = meta["clutter"]
    clutter = tsyn._boxes(rng, n, ext).astype(np.float32)
    scans, poses = [], []
    for i in range(meta["scans"]):
        px, py, yaw = -1.0 + 0.4 * i, 0.2 * i, 0.1 * i
        pts, lab = tsyn.sample_scan(rng, stable, clutter, np.array([px, py]),
                                    n_rays=meta["n_rays"], max_r=meta["max_r"])
        pose = np.eye(4)
        c, s_ = np.cos(yaw), np.sin(yaw)
        pose[:3, :3] = [[c, -s_, 0.0], [s_, c, 0.0], [0.0, 0.0, 1.0]]
        pose[:3, 3] = [px, py, 0.0]
        local = (pts - pose[:3, 3]) @ pose[:3, :3]
        scans.append(np.concatenate([local, lab[:, None]], 1).astype(np.float32))
        poses.append(pose)
    return scans, poses, stable


def baseline_train_config(meta=BT_META):
    """meta's config as an sps_tpu Config whose sps_config carries meta's
    capacities (the port's half: sps_torch.scripts.train_baselines.pin_config)."""
    from sps_tpu import config as jcfg_mod
    from sps_tpu.structs import Capacities

    cfg = jcfg_mod.load(os.path.join(HERE, meta["config"]))
    cfg = dataclasses.replace(cfg, voxel_size=meta["voxel_size"])
    caps = Capacities(points=meta["caps"]["points"], voxels=tuple(meta["caps"]["voxels"]),
                      bricks=tuple(meta["caps"]["bricks"]))

    class Small(type(cfg)):
        def sps_config(self, batch_size=None):
            return dataclasses.replace(super().sps_config(batch_size), caps=caps)

    return Small(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


PIN_SAMPLE = 1024  # entries kept of a leaf larger than this (evenly spaced)


def pin_sample(a):
    """A leaf as stored in the baseline train pin: whole when it has at most
    PIN_SAMPLE entries, else PIN_SAMPLE evenly spaced entries of its flat
    view (tests/test_torch_train_baselines.py takes the same ones)."""
    flat = np.asarray(a, np.float32).reshape(-1)
    if flat.size <= PIN_SAMPLE:
        return flat
    return flat[(np.arange(PIN_SAMPLE) * flat.size) // PIN_SAMPLE]


def lts_flax_tree(sd):
    """SPCTReg state_dict -> flax variables (Linear weight (out, in) ->
    Dense kernel (in, out))."""
    return flax_tree({(k[:-len("weight")] + "kernel" if k.endswith(".weight") else k):
                      (v.T.contiguous() if k.endswith(".weight") else v)
                      for k, v in sd.items()})


def export_baseline_train_pin():
    """One step of each of scripts/train_baselines.py's trainers, run as the
    script runs them, from the port trainers' seeded initial weights
    (jax.jit wrapped: model.init returns those weights, step_fn records its
    inputs and outputs; the checkpoint write skipped; LTS with dropout 0):
    the batch, the loss, the batch_stats after the step, and of every
    gradient leaf and every parameter after the step its max-abs, sum and
    sum of squares (f64) and its entries (pin_sample). MOS4D is recorded
    twice: as the script runs it (bf16, "mos4d") and with level 0's
    occupancy in f32 ("mos4d_f32"), where rounding does not hide the
    arithmetic."""
    import functools

    import jax
    from flax.core import unfreeze

    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import train_baselines as jtb

    from sps_tpu.models import lts as jlts
    from sps_tpu.utils import checkpoint as jckpt
    from sps_torch.scripts import train_baselines as ttb

    meta = BT_META
    scans, poses, mp = baseline_train_inputs(meta)
    cfg = baseline_train_config(meta)
    seed = meta["seed"]
    from sps_tpu.models import mos4d as jm4

    real_pyramid = jm4.build_pyramid

    def f32_pyramid(pb, scfg):
        """build_pyramid with level 0's occupancy in f32: MOS4D's network
        then computes in f32 (its input feature is 0.5 * that occupancy)."""
        levels, p2s, overflow = real_pyramid(pb, scfg)
        lv0 = levels[0]._replace(grid=levels[0].grid.replace(
            occ=levels[0].grid.occ.astype(jax.numpy.float32)))
        return [lv0, *levels[1:]], p2s, overflow

    inits = {  # the port trainers' initial weights, as flax variables
        "mos4d": flax_tree(ttb.pin_model("mos4d", meta)[0].state_dict()),
        "mapmos": flax_tree(ttb.pin_model("mapmos", meta)[0].state_dict()),
        "lts": lts_flax_tree(ttb.pin_model("lts", meta)[0].state_dict())}
    records, current = [], []
    real_jit, real_save, real_lts = jax.jit, jckpt.save, jlts.SPCTReg

    def recording_jit(f, *a, **k):
        if getattr(f, "__name__", "") == "init":
            return lambda *args: jax.tree.map(jax.numpy.asarray, inits[current[0]])
        j = real_jit(f, *a, **k)
        if getattr(f, "__name__", "") != "step_fn":
            return j

        def call(*args):
            out = j(*args)
            records.append(jax.tree.map(np.asarray, (args, out)))
            return out

        return call

    out = {"meta": np.asarray(json.dumps({**meta, "pin_sample": PIN_SAMPLE})), "map": mp,
           "poses": np.stack(poses), "scan_sizes": np.asarray([len(x) for x in scans]),
           "scans": np.concatenate(scans)}
    jax.jit, jckpt.save = recording_jit, (lambda *a, **k: None)
    jlts.SPCTReg = functools.partial(real_lts, dropout=meta["lts_dropout"])
    try:
        steps = meta["steps"]
        runs = {
            "mos4d": lambda: jtb.train_mos4d(cfg, scans, poses, True, steps, meta["n_scans"],
                                             meta["ns"], "unused", seed),
            "mapmos": lambda: jtb.train_mapmos(cfg, scans, poses, mp, steps, meta["ns"],
                                               meta["nm"], "unused", seed),
            "lts": lambda: jtb.train_lts(cfg, scans, steps, "unused", seed)}
        runs["mos4d_f32"] = runs["mos4d"]
        for name, run in runs.items():
            t = time.time()
            records.clear()
            current[:] = [name.removesuffix("_f32")]
            jm4.build_pyramid = f32_pyramid if name == "mos4d_f32" else real_pyramid
            run()
            args, (params_1, bstats_1, opt_1, loss) = records[0]
            batch = args[3:5] if name == "lts" else args[3:]  # LTS: no dropout key
            # optax.adam's first moment after one step from zero is (1 - b1) g.
            grads = jax.tree.map(lambda m: m / (1.0 - 0.9), opt_1[0].mu)
            out[f"{name}/loss"] = np.float64(loss)
            for i, b in enumerate(batch):
                out[f"{name}/batch/{i}"] = np.asarray(b)
            out.update({f"{name}/batch_stats_1/{k}": v
                        for k, v in flat_tree(unfreeze(bstats_1)).items()})
            for prefix, tr_ in (("grads", grads), ("params_1", params_1)):
                for k, v in flat_tree(unfreeze(tr_)).items():
                    v64 = v.astype(np.float64)
                    out[f"{name}/{prefix}/{k}"] = pin_sample(v)
                    out[f"{name}/{prefix}_stats/{k}"] = np.asarray(
                        [np.abs(v64).max(), v64.sum(), (v64 ** 2).sum(), v.size])
            log(f"baseline train pin {name}: loss {float(loss):.6f} ({time.time() - t:.0f} s)")
    finally:
        jax.jit, jckpt.save, jlts.SPCTReg = real_jit, real_save, real_lts
        jm4.build_pyramid = real_pyramid
    np.savez_compressed(os.path.join(ASSETS, "baseline_train_pin.npz"), **out)


# scripts/check_nclt_headroom.py at config_nclt.yaml, cut for the CPU: each
# entry of "cut" replaces the shipped value beside it in "shipped".
NCLT_META = {"config": "config/config_nclt.yaml",
             "cut": {"extent": 4.0, "scans": 2, "n_stable": 4, "n_clutter": 2, "n_rays": 280,
                     "scan_points": 4096, "bricks": [1024, 512, 512, 512, 512],
                     "voxels": [16384, 8192, 4096, 2048, 1024]},
             "shipped": {"extent": 110.0, "scans": 12, "n_stable": 580, "n_clutter": 120,
                         "n_rays": 8640, "scan_points": 131072,
                         "bricks": [28672, 8192, 2560, 1536, 1024],
                         "voxels": [262144, 65536, 49152, 24576, 8192]},
             "stats": ["n_scan_voxels", "n_submap_voxels", "overflow", "topo_miss_points"]}


def nclt_world(meta=NCLT_META):
    """scripts/check_nclt_headroom.py's world (sps_tpu.data.synthetic) at
    meta's cut: (map, scans, valids)."""
    from sps_tpu.data import synthetic as jsyn

    c = meta["cut"]
    extent, ns = c["extent"], c["scan_points"]
    rng = np.random.default_rng(7)
    stable = jsyn.make_world(seed=7, extent=extent, n_stable=c["n_stable"],
                             ground_points=int(1_200_000 * (extent / 50.0) ** 2))
    clutter = jsyn._boxes(rng, c["n_clutter"], extent * 0.8).astype(np.float32)
    scans = np.zeros((c["scans"], ns, 3), np.float32)
    valids = np.zeros((c["scans"], ns), bool)
    for i in range(c["scans"]):
        ang = 2 * np.pi * i / c["scans"]
        pose_xy = (0.5 * extent) * np.array([np.cos(ang), np.sin(ang)])
        pts, _ = jsyn.sample_scan(rng, stable, clutter, pose_xy, n_rays=c["n_rays"], max_r=30.0)
        k = min(len(pts), ns)
        scans[i, :k], valids[i, :k] = pts[:k], True
    return stable, scans, valids


def nclt_config(mod, meta=NCLT_META):
    cfg = mod.load(os.path.join(HERE, meta["config"]))
    c = meta["cut"]
    return dataclasses.replace(cfg, tpu=dataclasses.replace(
        cfg.tpu, scan_points=c["scan_points"], bricks=tuple(c["bricks"]),
        voxels=tuple(c["voxels"])))


def export_nclt_pin():
    """sps_tpu's StreamingFilter (create_state's weights, seed 0) over
    nclt_world at nclt_config: the world and every scan's integer stats."""
    import jax

    from sps_tpu import config as jcfg_mod
    from sps_tpu import train as tr
    from sps_tpu.stream.engine import StreamingFilter

    meta = NCLT_META
    cfg = nclt_config(jcfg_mod, meta)
    stable, scans, valids = nclt_world(meta)
    state = tr.create_state(cfg, jax.random.PRNGKey(0), steps_per_epoch=1)
    filt = StreamingFilter(cfg, {"params": state.params, "batch_stats": state.batch_stats},
                           stable)
    t = time.time()
    eye = np.eye(4, dtype=np.float32)
    labels = np.zeros((scans.shape[1],), np.float32)
    rows = [filt(scans[i], valids[i], labels, eye)[2] for i in range(len(scans))]
    out = {"meta": np.asarray(json.dumps(meta)), "stable": stable, "scans": scans,
           "valids": valids}
    for k in meta["stats"]:
        out[k] = np.asarray([int(r[k]) for r in rows])
    np.savez_compressed(os.path.join(ASSETS, "nclt_pin.npz"), **out)
    log(f"nclt pin: " + ", ".join(f"{k} {out[k].tolist()}" for k in meta["stats"])
        + f" ({time.time() - t:.0f} s)")


# The measurement tools' pins: scripts/measure_occupancy.py's program over
# bench.py's 24 scans at config.yaml as shipped, and
# scripts/measure_topo_reuse.py's trajectories at a depth the CPU affords
# (TOPO_META lists each cut; neither the UNet's width nor its arithmetic
# changes which points a cached topology misses).
OCC_META = {"config": "config/config.yaml", "scans": 24, "extent": 50.0}
TOPO_META = {"config": "config/config.yaml", "steps": [0.2, 1.0, 6.5], "k": 8,
             "cut": {"scans": 16, "narrow": LOOP_NARROW, "bf16": False, "int8": False},
             "shipped": {"scans": 24}}


def jax_occupancy(cfg, stable, scans, valids):
    """scripts/measure_occupancy.py's `occupancy` program (sps_tpu, the
    atlas engine: voxelize + overlap, the pyramid, no UNet) over the scans:
    per scan and level (occupied bricks or rows, capacity, overflow)."""
    import jax
    import jax.numpy as jnp

    from sps_tpu.models import spsnet
    from sps_tpu.ops import atlas as atl
    from sps_tpu.ops import brick as bk
    from sps_tpu.ops import voxelize as vox
    from sps_tpu.stream.engine import build_map_atlas

    sps_cfg = cfg.sps_config(batch_size=1)
    assert cfg.tpu.engine == "atlas", "occupancy sweep assumes the atlas engine"
    map_grid = build_map_atlas(stable, cfg.voxel_size, cfg.tpu.brick_side)
    n = scans.shape[1]
    bcap = sps_cfg.caps.bricks[0]
    vsize = cfg.voxel_size

    @jax.jit
    def occupancy(map_grid, scan_xyz, valid):
        coords = vox.quantize(scan_xyz, vsize)
        zeros = jnp.zeros((n,), jnp.int32)
        ones = jnp.ones((n,), jnp.int32)
        grid, p2s = atl.voxelize_bricks(
            coords, zeros, ones, valid,
            num_time=2, brick_capacity=bcap,
            brick_side=sps_cfg.brick_side, extent=sps_cfg.atlas_extent,
        )
        bvalid = jnp.arange(bcap) < grid.num_bricks
        batch0 = jnp.where(bvalid, 0, -1)
        mrow = atl.atlas_rows(map_grid, batch0, grid.coords[:, 1:])
        mocc = bk.take_rows(map_grid.occ, mrow)[..., 0]
        overlap = grid.occ[..., 1] * mocc
        occ = grid.occ.at[..., 0].set(overlap)
        grid = grid._replace(occ=occ)
        levels, _ = spsnet.build_levels_from_grid(grid, sps_cfg)
        out = []
        for l in levels:
            gg = l.grid
            if hasattr(gg, "num_rows"):
                out.append((gg.num_rows, gg.occ.shape[0], gg.overflow))
            else:
                out.append((gg.num_bricks, gg.coords.shape[0],
                            getattr(gg, "overflow", jnp.zeros((), bool))))
        return out

    return np.asarray([[(int(a), int(b), bool(c)) for a, b, c in jax.device_get(
        occupancy(map_grid, jnp.asarray(scans[i]), jnp.asarray(valids[i])))]
        for i in range(len(scans))])


def jax_topo_reuse(cfg, variables, stable, steps, k, n_scans, radius=25.0, n_clutter=40,
                   clutter_extent=40.0, n_rays=360 * 24, max_r=30.0, seed=1):
    """scripts/measure_topo_reuse.py's loop (sps_tpu's StreamingFilter at
    TOPO_EVERY k; the trajectory's keywords are the script's constants):
    per step, per scan (topology-miss points, valid points, the valid
    points' fingerprint, sps_torch.data.bench_world.fingerprint)."""
    from sps_torch.data.bench_world import fingerprint
    from sps_tpu.data import synthetic as jsyn
    from sps_tpu.stream.engine import StreamingFilter

    cfg = dataclasses.replace(cfg, tpu=dataclasses.replace(cfg.tpu, topo_every=k))
    ns = cfg.tpu.scan_points
    filt = StreamingFilter(cfg, variables, stable)
    rng = np.random.default_rng(seed)
    clutter = jsyn._boxes(rng, n_clutter, clutter_extent).astype(np.float32)
    out = {}
    for step in steps:
        filt.invalidate()
        rows = []
        for i in range(n_scans):
            ang = (step * i) / radius
            pose_xy = radius * np.array([np.cos(ang), np.sin(ang)])
            pts, lab = jsyn.sample_scan(rng, stable, clutter, pose_xy, n_rays=n_rays,
                                        max_r=max_r)
            kk = min(len(pts), ns)
            sx = np.zeros((ns, 3), np.float32)
            sl = np.zeros((ns,), np.float32)
            sv = np.zeros((ns,), bool)
            sx[:kk], sl[:kk], sv[:kk] = pts[:kk], lab[:kk], True
            _, _, stats = filt(sx, sv, sl, np.eye(4, dtype=np.float32))
            rows.append((int(stats["topo_miss_points"]), int(sv.sum()), fingerprint(sx[sv])))
        out[step] = rows
    return out


def export_occupancy_pin():
    """sps_tpu's per-level occupancy (jax_occupancy) over bench.py's 24
    scans at config.yaml as shipped: per scan and level the occupied bricks
    or rows and the overflow flag, the capacities, and each scan's valid
    points and their fingerprint (sps_torch.data.bench_world.fingerprint)."""
    import bench
    from sps_torch.data.bench_world import fingerprint
    from sps_tpu import config as jcfg_mod

    meta = OCC_META
    t = time.time()
    cfg = jcfg_mod.load(os.path.join(HERE, meta["config"]), data_root="/tmp")
    stable, scans, _, valids = bench._make_data(cfg, meta["scans"], extent=meta["extent"])
    res = jax_occupancy(cfg, stable, scans, valids)
    out = {"meta": np.asarray(json.dumps(meta)), "num": res[..., 0].astype(np.int64),
           "cap": res[0, :, 1].astype(np.int64), "overflow": res[..., 2].astype(bool),
           "valid": valids.sum(1),
           "xyz_sha": np.asarray([fingerprint(s[v]) for s, v in zip(scans, valids)])}
    np.savez_compressed(os.path.join(ASSETS, "occupancy_pin.npz"), **out)
    log(f"occupancy pin: max {out['num'].max(0).tolist()} / cap {out['cap'].tolist()}, "
        f"overflow scans {np.flatnonzero(out['overflow'].any(1)).tolist()} "
        f"({time.time() - t:.0f} s)")


def export_topo_reuse_pin():
    """sps_tpu's topology misses (jax_topo_reuse) on measure_topo_reuse.py's
    trajectories at TOPO_META's cut, with the port's seeded weights (seed 0):
    per step the misses, valid points and fingerprints of every scan."""
    import bench
    from sps_tpu import config as jcfg_mod
    from sps_torch.models import spsnet as tsps
    from sps_torch import config as tcfg_mod

    meta = TOPO_META
    t = time.time()
    cut = meta["cut"]

    def narrowed(mod):
        cfg = mod.load(os.path.join(HERE, meta["config"]), data_root="/tmp")
        cfg = dataclasses.replace(cfg, tpu=dataclasses.replace(cfg.tpu, bf16=cut["bf16"],
                                                               int8=cut["int8"]))

        class Narrow(type(cfg)):
            def sps_config(self, batch_size=None):
                s = super().sps_config(batch_size)
                return dataclasses.replace(s, unet=dataclasses.replace(s.unet, **cut["narrow"]))

        return Narrow(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})

    cfg = narrowed(jcfg_mod)
    stable = bench._make_data(cfg, 24)[0]
    sd = tsps.init_state_dict(narrowed(tcfg_mod).sps_config(1), seed=0)
    res = jax_topo_reuse(cfg, flax_tree(sd), stable, meta["steps"], meta["k"], cut["scans"])
    out = {"meta": np.asarray(json.dumps(meta))}
    for step, rows in res.items():
        out[f"miss/{step}"] = np.asarray([r[0] for r in rows], np.int64)
        out[f"valid/{step}"] = np.asarray([r[1] for r in rows], np.int64)
        out[f"xyz_sha/{step}"] = np.asarray([r[2] for r in rows])
    np.savez_compressed(os.path.join(ASSETS, "topo_reuse_pin.npz"), **out)
    log("topo reuse pin: " + "; ".join(f"{step} m misses {out[f'miss/{step}'].tolist()}"
                                       for step in meta["steps"])
        + f" ({time.time() - t:.0f} s)")


def tests_module(name):
    """A module of tests/: the pins below run sps_tpu on a test's own inputs,
    which that module builds."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    return importlib.import_module(name)


def write_pin(name, records):
    """sps_torch/assets/<name>: each key's arrays under "<key>/", and under
    `meta` each key's record of its inputs, which the test that reads the
    pin checks against its own (tests/test_torch_stream.py's pinned)."""
    out = {f"{key}/{k}": np.asarray(v) for key, (_, arrays) in records.items()
           for k, v in arrays.items()}
    meta = {key: record for key, (record, _) in records.items()}
    np.savez_compressed(os.path.join(ASSETS, name), meta=np.asarray(json.dumps(meta)), **out)
    log(f"{name}: {', '.join(meta)}")


def write_stream_pin(name, runs):
    """sps_tpu's StreamingFilter over each run's scans: per run key and scan
    the scores, keep and stats (tests/test_torch_stream.py's pinned_runs)."""
    import jax
    from sps_tpu.stream.engine import StreamingFilter

    stream = tests_module("test_torch_stream")
    records = {}
    for key, (cfg, sd, mp, argss, run_meta) in runs.items():
        filt = StreamingFilter(cfg, jax.tree.map(np.asarray, flax_tree(sd)), mp)
        arrays = {}
        for i, args in enumerate(argss):
            scores, keep, stats = filt(*args)
            arrays.update({f"{i}/scores": scores, f"{i}/keep": keep,
                           **{f"{i}/stats/{k}": v for k, v in stats.items()}})
        records[key] = (stream.pin_record(run_meta, mp, argss, sd), arrays)
    write_pin(name, records)


def export_shipping_pin():
    """sps_tpu's StreamingFilter at config.yaml's TPU options on
    tests/test_torch_shipping.py's world (three scans: rebuild, reuse,
    rebuild)."""
    from sps_tpu import config as jcfg_mod

    ship = tests_module("test_torch_shipping")
    with tempfile.TemporaryDirectory() as root:
        _, mp, argss, sd = ship.inputs(root)
    write_stream_pin("shipping_pin.npz",
                     {"shipping": (ship._load(jcfg_mod), sd, mp, argss, ship.META)})


def export_zband_levels_pin():
    """sps_tpu's StreamingFilter in conv_mode zband at ZBAND_LEVELS 2 and 3 on
    tests/test_torch_zband_levels_stream.py's world (one rebuild scan)."""
    from sps_tpu import config as jcfg_mod

    zl = tests_module("test_torch_zband_levels_stream")
    runs = {}
    for levels in zl.LEVELS:
        with tempfile.TemporaryDirectory() as root:
            _, mp, argss, sd = zl.inputs(root, levels)
        runs[f"levels{levels}"] = (zl.with_levels(zl._load(jcfg_mod), levels), sd, mp, argss,
                                   {**zl.META, "zband_levels": levels})
    write_stream_pin("zband_levels_stream_pin.npz", runs)


def export_dist_stream_pin():
    """sps_tpu's StreamingFilter with the distance feature on
    tests/test_torch_dist.py's world (three scans: rebuild, reuse, rebuild)."""
    from sps_tpu import config as jcfg_mod

    dist = tests_module("test_torch_dist")
    with tempfile.TemporaryDirectory() as root:
        _, mp, argss, sd = dist.inputs(root)
    write_stream_pin("dist_stream_pin.npz", {"dist": (dist._with_dist(dist._load(jcfg_mod)), sd,
                                                      mp, argss, dist.STREAM_META)})


def spsmodel_arrays(cfg, sd, args):
    """sps_tpu's SPSModel (jitted) on pad_point_batch(*args) with the port's
    weights sd: the scores and the overflow flags."""
    import jax

    from sps_tpu.models.spsnet import SPSModel
    from sps_tpu.structs import pad_point_batch

    scores, aux = jax.jit(lambda v, b: SPSModel(cfg).apply(v, b))(
        jax.tree.map(np.asarray, flax_tree(sd)), pad_point_batch(*args))
    return {"scores": scores, "overflow": aux["overflow"]}


def export_spsmodel_pin():
    """sps_tpu's SPSModel on the gather engine (tests/test_torch_gather_engine.py),
    on the brick engine at sps_tpu's defaults (tests/test_torch_brick_engine.py)
    and at the default config (tests/test_torch_config.py), on those tests'
    points and weights."""
    from sps_torch.models import spsnet as tsps
    from sps_torch.models.minkunet import MinkUNetConfig as TUNetConfig
    from sps_torch.structs import Capacities as TCaps
    from sps_tpu.models.minkunet import MinkUNetConfig as JUNetConfig
    from sps_tpu.models.spsnet import SPSConfig as JSPSConfig
    from sps_tpu.structs import Capacities as JCaps

    ge = tests_module("test_torch_gather_engine")
    be = tests_module("test_torch_brick_engine")
    tc = tests_module("test_torch_config")
    stream = tests_module("test_torch_stream")
    sd = tsps.init_state_dict(ge.TCFG, seed=0)
    gather_args = (*ge._points(3), ge.CAPS["points"])
    brick_args = (*ge._points(5), ge.CAPS["points"])
    default_cfg = tc.default_config(tsps.SPSConfig, TCaps, TUNetConfig)
    default_sd = tsps.init_state_dict(default_cfg, seed=0)
    runs = {"gather": (ge.TCFG, ge.JCFG, sd, gather_args),
            "brick_defaults": (be.brick_defaults(tsps.SPSConfig, TCaps, TUNetConfig),
                               be.brick_defaults(JSPSConfig, JCaps, JUNetConfig), sd, brick_args),
            "default_engine": (default_cfg, tc.default_config(JSPSConfig, JCaps, JUNetConfig),
                               default_sd, tc.default_inputs())}
    write_pin("spsmodel_pin.npz", {
        key: (stream.model_record(tcfg, w, args), spsmodel_arrays(jcfg, w, args))
        for key, (tcfg, jcfg, w, args) in runs.items()})


def export_gather_stream_pin():
    """sps_tpu's StreamingFilter on config_small.yaml as shipped (the gather
    engine), narrowed, on tests/test_torch_gather_engine.py's world."""
    from sps_tpu import config as jcfg_mod

    ge = tests_module("test_torch_gather_engine")
    with tempfile.TemporaryDirectory() as root:
        _, mp, argss, sd = ge.stream_inputs(root)
    write_stream_pin("gather_stream_pin.npz",
                     {"gather": (ge._load(jcfg_mod), sd, mp, argss, ge.STREAM_META)})


def export_halo_pin():
    """sps_tpu's SPSModel in conv_mode halo (int8 and head_fold off, and on) on
    tests/test_torch_halo.py's points and weights: the scores and overflow."""
    h = tests_module("test_torch_halo")
    m = tests_module("test_torch_model")
    stream = tests_module("test_torch_stream")
    sd, pts = h.inputs()
    args = (*pts, m.CAPS["points"])
    write_pin("halo_pin.npz", {
        opts: (stream.model_record(h.halo(m.TCFG, opts), sd, args),
               spsmodel_arrays(h.halo(m.JCFG, opts), sd, args)) for opts in h.OPTIONS})


def export_mapmos_engines_pin():
    """sps_tpu's MapMOS on the brick and voxelize engines on
    tests/test_torch_mapmos_engines.py's points and weights: the logits and
    overflow."""
    import jax
    import jax.numpy as jnp

    from sps_tpu.models import mapmos
    from sps_tpu.structs import Capacities, pad_point_batch

    me = tests_module("test_torch_mapmos_engines")
    records = {}
    for engine in me.ENGINES:
        mm, args, idx = me.inputs(engine)
        net = mapmos.MapMOSNet(mapmos.MapMOSConfig(caps=Capacities(**me.CAPS),
                                                   **me.config(engine)))
        logits, aux = jax.jit(net.apply)(jax.tree.map(np.asarray, flax_tree(mm.state_dict())),
                                         pad_point_batch(*args), jnp.asarray(idx))
        records[engine] = (me.pin_record(engine, mm, args, idx),
                           {"logits": logits, "overflow": aux["overflow"]})
    write_pin("mapmos_engines_pin.npz", records)


def export_localize_soft_pin():
    """sps_tpu's run_localization with the sps-soft filter on
    tests/test_torch_localize_soft.py's world and weights: each scan's final
    pose and the result's entries that the test compares."""
    import jax

    from sps_tpu import config as jcfg_mod
    from sps_torch import config as tcfg_mod
    from sps_torch.data import synthetic as tsyn
    from sps_torch.models import spsnet as tsps

    ls = tests_module("test_torch_localize_soft")
    loc = tests_module("test_torch_localize")
    with tempfile.TemporaryDirectory() as root:
        tsyn.generate_dense(root, **ls.SOFT)
        sd = tsps.init_state_dict(ls.config(tcfg_mod, root).sps_config(1), seed=4)
        want, poses = loc._run_jax(ls.config(jcfg_mod, root),
                                   jax.tree.map(np.asarray, flax_tree(sd)), "20220629",
                                   "sps-soft", **ls.KW)
    write_pin("localize_soft_pin.npz", {"sps-soft": (ls.pin_record(sd), {
        "poses": poses, **{f"result/{k}": want[k] for k in ls.RESULT}})})


def jax_profile_stages(cfg, n):
    """scripts/profile_stream.py's stage functions (the atlas engine)."""
    import jax
    import jax.numpy as jnp

    from sps_tpu.models import spsnet
    from sps_tpu.models.minkunet import MinkUNet
    from sps_tpu.ops import atlas as atl
    from sps_tpu.ops import brick as bk
    from sps_tpu.ops import voxelize as vox

    sps_cfg = cfg.sps_config(batch_size=1)
    bcap = sps_cfg.caps.bricks[0]
    vsize = cfg.voxel_size

    @jax.jit
    def stage_vox(map_grid, scan_xyz, valid):
        coords = vox.quantize(scan_xyz, vsize)
        zeros = jnp.zeros((n,), jnp.int32)
        ones = jnp.ones((n,), jnp.int32)
        grid, p2s = atl.voxelize_bricks(
            coords, zeros, ones, valid,
            num_time=2, brick_capacity=bcap,
            brick_side=sps_cfg.brick_side, extent=sps_cfg.atlas_extent,
        )
        bvalid = jnp.arange(bcap) < grid.num_bricks
        batch0 = jnp.where(bvalid, 0, -1)
        mrow = atl.atlas_rows(map_grid, batch0, grid.coords[:, 1:])
        mocc = bk.take_rows(map_grid.occ, mrow)[..., 0]
        overlap = grid.occ[..., 1] * mocc
        occ = grid.occ.at[..., 0].set(overlap)
        return grid._replace(occ=occ), p2s

    @jax.jit
    def stage_topo(grid):
        return spsnet.build_levels_from_grid(grid, sps_cfg)[0]

    @jax.jit
    def stage_unet(variables, levels, p2s, valid):
        ucfg = sps_cfg.unet
        occ0 = levels[0].grid.occ
        feats0 = (0.5 * jnp.repeat(occ0, ucfg.in_channels, axis=-1)).astype(ucfg.dtype)
        unet = MinkUNet(ucfg, name="MinkUNet")
        out = unet.apply(
            {
                "params": variables["params"]["MinkUNet"],
                "batch_stats": variables["batch_stats"]["MinkUNet"],
            },
            feats0,
            levels,
            False,
        )
        per_point = vox.devoxelize_flat(
            out, p2s, jnp.ones((n,), jnp.int32), num_time=2,
            channels=ucfg.out_channels,
        )[:, 0].astype(jnp.float32)
        return jax.nn.sigmoid(per_point) * valid

    return stage_vox, stage_topo, stage_unet


def export_profile_stream_pin():
    """sps_tpu's three stages (jax_profile_stages) on
    tests/test_torch_profile_stream.py's scan: the stage-1 grid and
    point-to-slot map, each level's count, overflow and nbr27, the scores."""
    import jax
    import jax.numpy as jnp

    from sps_tpu import config as jcfg_mod
    from sps_tpu.stream.engine import build_map_atlas

    pst = tests_module("test_torch_profile_stream")
    with tempfile.TemporaryDirectory() as root:
        _, stable, x, v, sd = pst.inputs(root)
    cfg = pst._load(jcfg_mod)
    j_vox, j_topo, j_unet = jax_profile_stages(cfg, len(v))
    grid, p2s = j_vox(build_map_atlas(stable, cfg.voxel_size, cfg.tpu.brick_side),
                      jnp.asarray(x), jnp.asarray(v))
    levels = j_topo(grid)
    scores = j_unet(jax.tree.map(np.asarray, flax_tree(sd)), levels, p2s,
                    jnp.asarray(v, jnp.float32))
    # occ is bf16, which npz cannot hold; the test compares it in f32.
    arrays = {"grid/num_bricks": grid.num_bricks, "grid/coords": grid.coords,
              "grid/occ": np.asarray(grid.occ).astype(np.float32), "p2s": p2s, "scores": scores, "n_levels": len(levels)}
    for li, lv in enumerate(levels):
        arrays[f"levels/{li}/nbr27"] = lv.nbr27
        arrays.update({f"levels/{li}/{k}": getattr(lv.grid, k)
                       for k in ("num_rows", "num_bricks", "overflow") if hasattr(lv.grid, k)})
    write_pin("profile_stream_pin.npz", {"stages": (pst.pin_record(stable, x, v, sd), arrays)})


def export_measure_tools_pin():
    """sps_tpu's occupancy (jax_occupancy) and topology misses (jax_topo_reuse)
    on tests/test_torch_measure_tools.py's world and trajectories."""
    from sps_tpu import config as jcfg_mod
    from sps_torch import config as tcfg_mod
    from sps_torch.models import spsnet as tsps

    mt = tests_module("test_torch_measure_tools")
    with tempfile.TemporaryDirectory() as root:
        stable, xs, vs = mt.shipping_world(root, scans=mt.META["world_scans"])
    sd = tsps.init_state_dict(mt._cfg(tcfg_mod).sps_config(1), seed=mt.META["weights_seed"])
    cfg = mt._cfg(jcfg_mod)
    arrays = {"occupancy": jax_occupancy(cfg, stable, xs, vs)}
    topo = jax_topo_reuse(cfg, flax_tree(sd), stable, mt.STEPS, mt.K, mt.SCANS, **mt.TRAJ)
    for step, rows in topo.items():
        arrays.update({f"topo/{step}/{k}": col
                       for k, col in zip(("miss", "valid", "xyz_sha"), zip(*rows))})
    write_pin("measure_tools_pin.npz",
              {"measure_tools": (mt.pin_record(stable, xs, vs, sd), arrays)})


def export_register_pin():
    """sps_tpu's registration (sps_tpu.register) on tests/test_torch_register.py's
    world and cases(): both maps, the correspondences, distances, yaw search,
    registrations, pyramid, smallest eigenvectors and SE(3) exponentials that
    the test compares."""
    import jax
    import jax.numpy as jnp

    from sps_tpu import register as jreg

    rg = tests_module("test_torch_register")
    world = rg.make_world()
    cases = rg.cases(world)
    vms = {lut: jreg.build_voxel_map(world, rg.VOXEL, lut=flag) for lut, flag in rg.LUTS.items()}
    nv = int(vms["probes"].num_voxels)
    arrays = {"probes/num_voxels": nv, "probes/centroids": vms["probes"].centroids[:nv],
              "probes/normals": vms["probes"].normals[:nv],
              **{f"lut/{k}": getattr(vms["lut"], k)
                 for k in ("lut", "lut_dims", "lut_origin", "centroids")}}
    for lut, vm in vms.items():
        p, v = map(jnp.asarray, cases["query1"])
        arrays.update(zip((f"{lut}/correspond/{k}" for k in "cnh"), jreg._correspond(vm, p, v)))
        p, v = map(jnp.asarray, cases["query3"])
        arrays[f"{lut}/distance"] = jreg.point_map_distance(vm, p, v, cap=1.0)
        pose, stats = jax.jit(lambda s, v, g: jreg.register(vm, s, v, g, iters=20))(
            *map(jnp.asarray, cases["register"]))
        arrays.update({f"{lut}/register/pose": pose, f"{lut}/register/inliers": stats["inliers"],
                       f"{lut}/register/rmse": stats["rmse"]})
    vm = vms["lut"]
    p, v = cases["query2"]
    cols, h = jreg._correspond_cols(vm, jnp.concatenate([vm.centroids, vm.normals], -1),
                                    *(jnp.asarray(p[:, i]) for i in range(3)), jnp.asarray(v))
    arrays.update({"cols/c": np.stack([np.asarray(c) for c in cols], -1), "cols/h": h,
                   "yaw/pose": jreg.yaw_search(vm, *map(jnp.asarray, cases["yaw"])),
                   "evec": jreg._smallest_evec(jnp.asarray(cases["cov"][0])),
                   "se3": np.stack([jreg._exp_se3(jnp.asarray(d)) for d in cases["se3"]])})
    levels = tuple(jreg.build_voxel_map(world, v) for v in (1.6, rg.VOXEL))
    for start in (0, 1):
        scan, valid, guess, *w = cases[f"pyramid{start}"]
        pose, stats = jax.jit(lambda vms, s, v, g, pw: jreg.register_pyramid(
            vms, s, v, g, point_w=pw))(levels, *map(jnp.asarray, (scan, valid, guess)),
                                       jnp.asarray(w[0]) if w else None)
        arrays.update({f"pyramid{start}/pose": pose, f"pyramid{start}/inliers": stats["inliers"]})
    write_pin("register_pin.npz", {"register": (rg.pin_record(world), arrays)})


def export_topology_pin():
    """sps_tpu's voxelize and build_levels (jitted) on
    tests/test_torch_topology.py's points at its capacities: every array the
    test compares bit for bit."""
    import jax
    import jax.numpy as jnp

    from sps_tpu.ops import topology as jtopo
    from sps_tpu.ops import voxelize as jvox

    tp = tests_module("test_torch_topology")
    records = {}
    for case, cap in tp.VOXEL_CAPS.items():
        coords, batch, t, valid, feats = map(jnp.asarray, tp._points(0))
        g, p2v, pooled = jax.jit(lambda *a: jvox.voxelize(
            *a, num_time=tp.T, voxel_capacity=cap, features=feats))(coords, batch, t, valid)
        records[f"voxelize/{case}"] = (tp.pin_record(case, 0, cap), {
            **tp.grid_arrays(g, "grid/"), "point2voxel": p2v, "pooled": pooled,
            "devoxelize": jvox.devoxelize(pooled, p2v, t)})
    for case, caps in tp.LEVEL_CAPS.items():
        def run(c, b, tt, v):
            g, _, _ = jvox.voxelize(c, b, tt, v, num_time=tp.T, voxel_capacity=caps[0])
            return jtopo.build_levels(g, num_levels=5, capacities=caps, kernel_sizes=tp.KS)

        levels = jax.jit(run)(*map(jnp.asarray, tp._points(1)[:4]))
        records[f"levels/{case}"] = (tp.pin_record(case, 1, caps), tp.level_arrays(levels))
    write_pin("topology_pin.npz", records)


def export_int8_divergence_pin():
    """sps_tpu's jitted filter on each world of
    tests/test_torch_int8_divergence.py, its int8 conv recording: the scores
    and, per call of brick_conv_int8, the records the test compares."""
    dv = tests_module("test_torch_int8_divergence")
    records = {}
    for name in sorted(dv.WORLDS):
        s_j, rec_j = dv.sps_tpu_world(name)
        records[name] = (dv.pin_record(name), {
            "s_j": s_j, "calls": len(rec_j),
            **{f"{i}/{k}": rec[k] for i, rec in enumerate(rec_j) for k in dv.RECORD_KEYS}})
    write_pin("int8_divergence_pin.npz", records)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scans", type=int, default=20,
                    help="scans per movers sequence for the localization and predict pins (>= 20)")
    ap.add_argument("--only", default="ckpt,loc,loop,ckpt_v1,parity,predict,train,"
                                      "baselines,loc_baselines,hash,sp,dp,baseline_train,nclt,"
                                      "occupancy,topo_reuse,shipping,zband_levels,dist_stream,"
                                      "measure_tools,halo,mapmos_engines,localize_soft,spsmodel,"
                                      "gather_stream,profile_stream,register,topology,"
                                      "int8_divergence",
                    help="comma-separated subset of ckpt, loc, loop, ckpt_v1, parity, "
                         "predict, train, baselines, loc_baselines, hash, sp, dp, "
                         "baseline_train, nclt, occupancy, topo_reuse, shipping, "
                         "zband_levels, dist_stream, measure_tools, halo, mapmos_engines, "
                         "localize_soft, spsmodel, gather_stream, profile_stream, register, topology, "
                         "int8_divergence")
    args = ap.parse_args(argv)
    os.makedirs(ASSETS, exist_ok=True)
    parts = set(args.only.split(","))
    if "ckpt" in parts:
        export_checkpoint()
    if "loop" in parts:
        export_loop_pin()
    if "loc" in parts:
        export_loc_pin(args.scans)
    if "ckpt_v1" in parts:
        export_checkpoint(CKPT_V1, "ckpt_loc_movers")
    if "parity" in parts:
        export_parity_pin()
    if "predict" in parts:
        export_predict_pin(args.scans)
    if "train" in parts:
        export_train_pin()
    if "baselines" in parts:
        export_baselines()
    if "loc_baselines" in parts:
        export_loc_baselines_pin(args.scans)
    if "hash" in parts:
        export_hash_pin()
    if "sp" in parts:
        export_sp_pin()
        export_sp_step_pin()
    if "dp" in parts:
        export_dp_pin()
    if "baseline_train" in parts:
        export_baseline_train_pin()
    if "nclt" in parts:
        export_nclt_pin()
    if "occupancy" in parts:
        export_occupancy_pin()
    if "topo_reuse" in parts:
        export_topo_reuse_pin()
    if "shipping" in parts:
        export_shipping_pin()
    if "zband_levels" in parts:
        export_zband_levels_pin()
    if "dist_stream" in parts:
        export_dist_stream_pin()
    if "measure_tools" in parts:
        export_measure_tools_pin()
    if "halo" in parts:
        export_halo_pin()
    if "mapmos_engines" in parts:
        export_mapmos_engines_pin()
    if "localize_soft" in parts:
        export_localize_soft_pin()
    if "spsmodel" in parts:
        export_spsmodel_pin()
    if "gather_stream" in parts:
        export_gather_stream_pin()
    if "profile_stream" in parts:
        export_profile_stream_pin()
    if "register" in parts:
        export_register_pin()
    if "topology" in parts:
        export_topology_pin()
    if "int8_divergence" in parts:
        export_int8_divergence_pin()


if __name__ == "__main__":
    main()
