"""The streaming filter's stage seams and sps_torch/scripts/profile_stream.py
(CPU, f32): the three stage methods against the filter and against
scripts/profile_stream.py's three sps_tpu stages on the same scan.

test_torch_shipping.py's configuration and world: config_small.yaml with
config.yaml's TPU options (atlas, CONV_MODE halo, INT8, HEAD_FOLD), bf16 off,
MinkUNet14 narrowed, brick capacities (2048, 1024, 512, 512, 512) and a
12 m world (its first scan). Tolerances: the stage composition equals the filter's rebuild
bit for bit (atlas and brick engines); stages 1 and 2 equal sps_tpu's
exactly (grid, point-to-slot map, per-level counts, nbr27): no point of
this scan lies where dividing by the voxel size and multiplying by its
reciprocal (XLA under jit) disagree, which the test counts; stage 3's
scores hold the int8 tolerance of tests/test_torch_halo.py. sps_tpu's
stages are pinned by scripts/export_torch_assets.py --only profile_stream
(sps_torch/assets/profile_stream_pin.npz).
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from test_torch_halo import check_int8_scores
from test_torch_shipping import _load
from test_torch_stream import digest, pinned

import sps_torch.config as tcfg_mod
from sps_torch.data.bench_world import fingerprint
from sps_torch.models import spsnet as tsps
from sps_torch.scripts import profile_stream as ps
from sps_torch.stream.engine import StreamingFilter
from sps_torch.utils import profiling


def shipping_world(tmp, scans=1):
    """test_torch_shipping.py's world: the map and its first `scans` scans
    in the map frame (posed on the host), padded to SCAN_POINTS."""
    from sps_tpu.data import blt
    from sps_tpu.data import synthetic as jsyn

    jsyn.generate(tmp, sequences=("20220629",), scans_per_seq=scans, seed=3, extent=6.0,
                  n_rays=400, ground_points=4000, n_stable=8)
    raw, poses = blt.load_sequences_raw(tmp, ["20220629"])
    ns = _load(tcfg_mod).tpu.scan_points
    xs = np.zeros((scans, ns, 3), np.float32)
    vs = np.zeros((scans, ns), bool)
    for i, (scan, pose) in enumerate(zip(raw, poses)):
        pose = pose.astype(np.float32)
        pts = scan[:, :3].astype(np.float32) @ pose[:3, :3].T + pose[:3, 3]
        k = min(len(pts), ns)
        xs[i, :k], vs[i, :k] = pts[:k], True
    return blt.load_map(tmp, "base_map.asc.npy"), xs, vs


def inputs(root):
    """The configuration, map, scan, valid mask and weights of the stages."""
    cfg_t = _load(tcfg_mod)
    stable, xs, vs = shipping_world(root)
    return cfg_t, stable, xs[0], vs[0], tsps.init_state_dict(cfg_t.sps_config(1), seed=0)


def pin_record(stable, x, v, sd):
    """What profile_stream_pin.npz records of its inputs."""
    return {"world": "shipping_world", "scan": 0, "config": "test_torch_shipping._load",
            "map": fingerprint(stable), "points": fingerprint(x[v]), "weights": digest(sd)}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return inputs(str(tmp_path_factory.mktemp("world")))


@pytest.fixture(scope="module")
def jax_run(setup):
    """sps_tpu's three stages on the scan, as pinned: (grid, point2slot,
    levels, scores)."""
    _, stable, x, v, sd = setup
    pin = pinned("profile_stream_pin.npz", "stages", pin_record(stable, x, v, sd))
    grid = SimpleNamespace(**{k: pin[f"grid/{k}"] for k in ("num_bricks", "coords", "occ")})
    levels = [SimpleNamespace(
        grid=SimpleNamespace(**{k: pin[f"levels/{li}/{k}"] for k in ("num_rows", "num_bricks",
                                                                      "overflow")
                                if f"levels/{li}/{k}" in pin}),
        nbr27=pin[f"levels/{li}/nbr27"]) for li in range(int(pin["n_levels"]))]
    return grid, pin["p2s"], levels, pin["scores"]


@pytest.fixture(scope="module")
def port_run(setup):
    cfg, stable, x, v, sd = setup
    return _stages(StreamingFilter(cfg, sd, stable, device="cpu"), x, v)


def _stages(filt, x, v):
    """The three stages on one scan: (stage-1 output, levels, scores)."""
    with torch.inference_mode():
        vx = filt.stage_vox(torch.from_numpy(x)[None], torch.from_numpy(v)[None],
                            torch.eye(4)[None])
        levels, _ = filt.stage_topo(vx.grid)
        scores, _ = filt.stage_unet(levels, vx)
    return vx, levels, scores


def _int8_off(cfg, **tpu):
    return dataclasses.replace(cfg, tpu=dataclasses.replace(cfg.tpu, int8=False, **tpu))


@pytest.mark.parametrize("engine", ["atlas", "brick"])
def test_stages_compose_to_the_filter(setup, port_run, engine):
    """The atlas engine as configured (INT8); the brick engine (side 8,
    region convs) with INT8 off, whose plain int8 conv is slow on the CPU."""
    cfg, stable, x, v, sd = setup
    if engine == "atlas":
        scores = port_run[2]
    else:
        cfg = _int8_off(cfg, engine="brick", brick_side=8, conv_mode="region")
        sd = tsps.init_state_dict(cfg.sps_config(1), seed=0)
        scores = _stages(StreamingFilter(cfg, sd, stable, device="cpu"), x, v)[2]
    filt = StreamingFilter(cfg, sd, stable, device="cpu")
    s, keep, stats = filt(x, v, np.zeros(len(v), np.float32), np.eye(4, dtype=np.float32))
    assert not bool(stats["overflow"]) and int(stats["n_kept"]) > 0
    np.testing.assert_array_equal(scores.numpy(), s.numpy())
    np.testing.assert_array_equal(keep.numpy(), (scores.numpy() <= cfg.threshold) & v)


def test_stages_1_2_equal_sps_tpu(setup, port_run, jax_run):
    cfg, _, x, v, _ = setup
    vsize = np.float32(cfg.voxel_size)
    assert not (np.floor(x[v] / vsize) != np.floor(x[v] * (np.float32(1) / vsize))).any()
    vx, levels, _ = port_run
    grid, p2s, j_levels, _ = jax_run
    assert int(vx.grid.num_bricks) == int(grid.num_bricks) > 0
    np.testing.assert_array_equal(vx.grid.coords.numpy(), np.asarray(grid.coords))
    np.testing.assert_array_equal(vx.grid.occ.float().numpy(),
                                  np.asarray(grid.occ).astype(np.float32))
    np.testing.assert_array_equal(vx.p2v.numpy(), np.asarray(p2s))
    assert int(vx.overlap.sum()) > 0
    assert len(levels) == len(j_levels) == 5
    for li, (a, b) in enumerate(zip(levels, j_levels)):
        num = "num_rows" if hasattr(b.grid, "num_rows") else "num_bricks"
        assert int(getattr(a.grid, num)) == int(getattr(b.grid, num)), li
        assert bool(a.grid.overflow) == bool(b.grid.overflow) is False, li
        np.testing.assert_array_equal(a.nbr27.numpy(), np.asarray(b.nbr27), err_msg=f"L{li}")


def test_stage_3_matches_sps_tpu(setup, port_run, jax_run):
    cfg, _, _, v, _ = setup
    assert cfg.sps_config(1).unet.int8
    got = port_run[2].numpy()
    assert (got[v] > 0).all() and (got[~v] == 0).all()
    check_int8_scores(got, jax_run[3], v, cfg.threshold)


def test_profile_runs_the_stages(setup, tmp_path):
    """profile() on the CPU (INT8 off): the levels and scores of the stage
    methods, a time for each stage and the fused call, the chrome trace; no
    kernel on the CPU."""
    cfg, stable, x, v, sd = setup
    cfg = _int8_off(cfg)
    res = ps.profile(cfg, sd, stable, x, v, n=1, fused=True, trace_dir=str(tmp_path),
                     kernel_table=3, device="cpu", log=lambda m: None)
    _, levels, scores = _stages(StreamingFilter(cfg, sd, stable, device="cpu"), x, v)
    np.testing.assert_array_equal(res["scores"], scores.numpy())
    assert [r[0] for r in res["levels"]] == [
        int(getattr(lv.grid, "num_rows", getattr(lv.grid, "num_bricks", None))) for lv in levels]
    assert set(res["p50_ms"]) == {"vox", "topo", "unet", "fused"}
    assert all(res["min_ms"][k] <= res["p50_ms"][k] for k in res["p50_ms"])
    # first call + 1 timed + 1 profiled, and the fused program's 1 + 1
    assert res["unet_calls"] == 5
    assert res["launches"] == {"vox": 0, "topo": 0, "unet": 0}
    assert (tmp_path / "trace.json").stat().st_size > 0


def test_stage_timer_and_device_trace_on_the_cpu(tmp_path):
    timer = profiling.StageTimer()
    for _ in range(3):
        out = {}
        with timer.stage("matmul", block_on=lambda: out["y"]):
            out["y"] = torch.ones(64, 64) @ torch.ones(64, 64)
    with timer.stage("noop"):
        pass
    s = timer.summary()
    assert list(s) == ["matmul", "noop"] and timer.counts == {"matmul": 3, "noop": 1}
    assert len(timer.samples["matmul"]) == 3 and s["matmul"] >= 0.0
    assert abs(s["matmul"] - sum(timer.samples["matmul"]) / 3) < 1e-12
    profiling.synchronize({"a": (torch.zeros(2), [torch.ones(1)])})
    with profiling.device_trace(str(tmp_path / "tr")) as prof:
        with torch.profiler.record_function("sps.stage.unet"):
            torch.ones(8).sum()
    assert any(e.name == "sps.stage.unet" for e in prof.events())
    assert (tmp_path / "tr" / "trace.json").exists()
    with profiling.device_trace(None):
        pass
