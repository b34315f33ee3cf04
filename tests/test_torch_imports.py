"""The port stands alone: sps_torch and chip_smoke.py import nothing of JAX,
flax or sps_tpu (nor bench.py, nor click, which the card's machine lacks),
and the port's entry points default to the card."""

import ast
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "sps_tpu", "bench", "click")


def _port_files():
    files = [os.path.join(_ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(_ROOT, "sps_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_every_module_imports_with_jax_blocked():
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        for name in {BANNED!r}:
            sys.modules[name] = None  # any import of these raises ImportError
        import sps_torch
        mods = [m.name for m in pkgutil.walk_packages(sps_torch.__path__, "sps_torch.")]
        for m in mods:
            importlib.import_module(m)
        loaded = [m for m, v in sys.modules.items()
                  if v is not None and m.split(".")[0] in {BANNED!r}]
        assert not loaded, loaded
        print(" ".join(mods))
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=_ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    mods = r.stdout.split()
    assert len(mods) >= 35
    for m in ("register", "stream.loop", "stream.localize", "data.blt", "data.synthetic",
              "convert", "stream.engine", "pipeline", "eval", "ops.radius", "data.prefetch",
              "stream.replay", "scripts.predict", "train", "ops.augment", "utils.checkpoint",
              "scripts.train", "data.range_image", "models.lts", "models.mos4d",
              "models.mapmos", "stream.baselines", "ops.hash", "ops.topology",
              "parallel.comm", "parallel.spatial", "parallel.mesh", "parallel.launch",
              "scripts.train_baselines", "scripts.calibrate_threshold", "scripts.loc_experiment",
              "scripts.loc_calibrate_ate", "scripts.loc_pipeline",
              "scripts.check_nclt_headroom", "data.bench_world", "utils.profiling",
              "scripts.profile_stream", "scripts.measure_occupancy",
              "scripts.measure_topo_reuse", "scripts.make_synthetic_data",
              "scripts.measure_sp_scaling"):
        assert f"sps_torch.{m}" in mods, m


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, _ROOT))
def test_no_file_imports_jax_or_sps_tpu(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            names = [node.value] if node.value.split(".")[0] in BANNED else []
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in BANNED, f"{path}:{node.lineno} names {n}"


def test_streaming_filter_defaults_to_the_card():
    """device=None means CUDA; with no card the filter raises instead of
    moving to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from sps_torch import config
    from sps_torch.stream.engine import StreamingFilter

    cfg = config.load(os.path.join(_ROOT, "config", "config.yaml"))
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamingFilter(cfg, {}, np.zeros((10, 3), np.float32))


@pytest.mark.parametrize("entry", ["build_voxel_map", "LocalizationLoop", "run_localization",
                                   "run_localization_mos4d", "MaskFilter", "LTSFilter",
                                   "build_map_table", "build_map_bricks",
                                   "StreamingFilter_gather"])
def test_new_entry_points_default_to_the_card(entry):
    """The registration map, the loop, run_localization (a baseline's too),
    the baseline filters, the hash engines' resident maps and the filter on
    config_small.yaml as shipped (the gather engine) run on the card unless
    device="cpu" is passed."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from sps_torch import config, register
    from sps_torch.models import lts
    from sps_torch.stream import baselines
    from sps_torch.stream import engine
    from sps_torch.stream.localize import run_localization
    from sps_torch.stream.loop import LocalizationLoop

    cfg = config.load(os.path.join(_ROOT, "config", "config.yaml"))
    small = config.load(os.path.join(_ROOT, "config", "config_small.yaml"))
    pts = np.zeros((10, 3), np.float32)
    call = {"build_voxel_map": lambda: register.build_voxel_map(pts, 0.4),
            "LocalizationLoop": lambda: LocalizationLoop(cfg, {}, pts),
            "run_localization": lambda: run_localization(cfg, {}, "20220629", "raw"),
            "run_localization_mos4d": lambda: run_localization(cfg, {}, "20220629", "mos4d"),
            "MaskFilter": lambda: baselines.MaskFilter(pts, 0.1),
            "LTSFilter": lambda: baselines.LTSFilter(lts.init_state_dict()),
            "build_map_table": lambda: engine.build_map_table(pts, 0.1),
            "build_map_bricks": lambda: engine.build_map_bricks(pts, 0.1),
            "StreamingFilter_gather": lambda: engine.StreamingFilter(small, {}, pts)}[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        call()


@pytest.mark.parametrize("entry", ["predict_sequence", "replay_sequence"])
def test_offline_entry_points_default_to_the_card(entry, tmp_path):
    """predict_sequence and replay_sequence (the prefetcher's consumer) run
    on the card unless device="cpu" is passed: with no card they raise
    before reading any data."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from sps_torch import config
    from sps_torch.eval import predict_sequence
    from sps_torch.stream.replay import replay_sequence

    cfg = config.load(os.path.join(_ROOT, "config", "config.yaml"), data_root=str(tmp_path))
    call = {"predict_sequence": lambda: predict_sequence(cfg, {}),
            "replay_sequence": lambda: replay_sequence(cfg, {}, "20220629")}[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        call()


@pytest.mark.parametrize("entry", ["fit", "create_state"])
def test_training_defaults_to_the_card(entry, tmp_path):
    """fit and create_state train on the card unless device="cpu" is passed:
    with no card they raise before reading any data."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from sps_torch import config, train

    cfg = config.load(os.path.join(_ROOT, "config", "config.yaml"), data_root=str(tmp_path))
    call = {"fit": lambda: train.fit(cfg, log_dir=str(tmp_path), ckpt_dir=str(tmp_path)),
            "create_state": lambda: train.create_state(cfg, 0, 1)}[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        call()


def test_assemble_batch_stays_on_its_inputs_device():
    """assemble_batch runs where its inputs are; its callers pick the device."""
    import dataclasses

    from sps_torch import config, pipeline

    cfg = config.load(os.path.join(_ROOT, "config", "config.yaml"))
    cfg = dataclasses.replace(cfg, tpu=dataclasses.replace(
        cfg.tpu, submap_points=16, join_extent=(8, 8, 8)))
    x = torch.rand((1, 8, 3))
    pb, aux = pipeline.assemble_batch(x, torch.zeros(1, 8), torch.ones(1, 8, dtype=torch.bool),
                                      torch.rand(20, 3), cfg)
    assert pb.xyz.device.type == "cpu" and pb.xyz.shape == (24, 3)
    assert all(v.device.type == "cpu" for v in aux.values())


@pytest.mark.parametrize("entry", ["train_mos4d", "train_mapmos", "train_lts",
                                   "train_baselines", "calibrate_threshold", "loc_experiment",
                                   "loc_calibrate_ate", "loc_pipeline", "check_nclt_headroom",
                                   "headroom", "profile_stream", "measure_occupancy",
                                   "measure_topo_reuse", "measure_sp_scaling", "occupancy",
                                   "topo_reuse", "profile"])
def test_workflow_scripts_default_to_the_card(entry, tmp_path):
    """The baseline trainers, the workflow CLIs and the measurement tools run
    on the card unless asked for the CPU: with no card they raise before
    reading any data."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from sps_torch import config
    from sps_torch.scripts import (calibrate_threshold, check_nclt_headroom, loc_calibrate_ate,
                                   loc_experiment, loc_pipeline, measure_occupancy,
                                   measure_sp_scaling, measure_topo_reuse, profile_stream,
                                   train_baselines)

    cfg = config.load(os.path.join(_ROOT, "config", "config_loc.yaml"), data_root=str(tmp_path))
    pts = np.zeros((10, 4), np.float32)
    out = str(tmp_path / "out")
    call = {
        "train_mos4d": lambda: train_baselines.train_mos4d(cfg, [pts] * 5, [np.eye(4)] * 5, True,
                                                           1, 4, 8, out, 0),
        "train_mapmos": lambda: train_baselines.train_mapmos(cfg, [pts], [np.eye(4)], pts[:, :3],
                                                             1, 8, 8, out, 0),
        "train_lts": lambda: train_baselines.train_lts(cfg, [pts], 1, out, 0),
        "train_baselines": lambda: train_baselines.main(["--data", str(tmp_path)]),
        "calibrate_threshold": lambda: calibrate_threshold.main(["-w", "x.npz"]),
        "loc_experiment": lambda: loc_experiment.main(["--out", out]),
        "loc_calibrate_ate": lambda: loc_calibrate_ate.main(["--out", out]),
        "loc_pipeline": lambda: loc_pipeline.main(["--out", out]),
        "check_nclt_headroom": lambda: check_nclt_headroom.main([]),
        "headroom": lambda: check_nclt_headroom.headroom(cfg, pts[:, :3], np.zeros((1, 8, 3)),
                                                         np.ones((1, 8), bool)),
        "profile_stream": lambda: profile_stream.main(["--scans", "1"]),
        "measure_occupancy": lambda: measure_occupancy.main([]),
        "measure_topo_reuse": lambda: measure_topo_reuse.main(["--out", out]),
        "measure_sp_scaling": lambda: measure_sp_scaling.main(["--out", out]),
        "occupancy": lambda: measure_occupancy.occupancy(cfg, pts[:, :3], np.zeros((1, 8, 3)),
                                                         np.ones((1, 8), bool)),
        "topo_reuse": lambda: measure_topo_reuse.topo_reuse(cfg, {}, pts[:, :3]),
        "profile": lambda: profile_stream.profile(cfg, {}, pts[:, :3], np.zeros((8, 3)),
                                                  np.ones(8, bool)),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        call()
    assert not os.path.exists(out)
