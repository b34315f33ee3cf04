"""sps_torch/stream/loop.py against sps_tpu/stream/loop.py (CPU, f32).

The fused loop on tests/test_loop.py's tiny world (4 scans, atlas engine,
TOPO_EVERY 4, the first two scans seeded with the ground truth) with and
without refine, at narrow widths with the port's seeded weights. sps_tpu's
LocalizationLoop compiles its rebuild and reuse steps (filter + ICP) in ~2
minutes on this CPU, longer than this file may run, so the port is held
against sps_tpu's results pinned by scripts/export_torch_assets.py
(sps_torch/assets/loop_tiny_pin.npz) on the same world and weights.
Tolerances: poses 1e-3 m / 1e-3 (rotation entries), the ICP's sums being
taken in another order; keep decisions equal but for 0.5% of the points
(scores within rtol 1e-3 of sps_tpu's flip near epsilon); inliers within
1%. The cv prior's helpers against sps_tpu's directly."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sps_torch.config as tcfg_mod
from sps_torch.convert import ASSETS
from sps_torch.models import spsnet as tsps
from sps_torch.stream import loop as tloop
from sps_tpu.stream import loop as jloop

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_ROOT, "scripts"))
import export_torch_assets as exp  # noqa: E402

PIN = os.path.join(ASSETS, "loop_tiny_pin.npz")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    scans, gt, mp = exp.loop_inputs(str(tmp_path_factory.mktemp("loop")))
    cfg = exp.loop_config(tcfg_mod)
    sd = tsps.init_state_dict(cfg.sps_config(1), seed=exp.LOOP_SEED)
    pin = dict(np.load(PIN))
    np.testing.assert_allclose(sum(float(v.abs().sum()) for v in sd.values()),
                               pin["weights_abs_sum"], rtol=1e-6)
    return cfg, sd, scans, gt, mp, pin


def _pad(scan, ns):
    n = min(len(scan), ns)
    sx = np.zeros((ns, 3), np.float32)
    sl = np.zeros((ns,), np.float32)
    sv = np.zeros((ns,), bool)
    sx[:n], sl[:n], sv[:n] = scan[:n, :3], scan[:n, 3], True
    return sx, sv, sl


@pytest.mark.parametrize("refine", [True, False], ids=["refine", "norefine"])
def test_loop_matches_sps_tpu(setup, refine):
    cfg, sd, scans, gt, mp, pin = setup
    tag = "refine" if refine else "norefine"
    loop = tloop.LocalizationLoop(cfg, sd, mp, refine=refine, device="cpu")
    ns = cfg.tpu.scan_points
    for i, scan in enumerate(scans):
        sx, sv, sl = _pad(scan, ns)
        prior = gt[i].astype(np.float32) if i <= 1 else None
        pose, keep, st = loop(sx, sv, sl, prior=prior)
        pose, keep = pose.numpy(), keep.numpy()
        want = pin[f"{tag}/poses"][i]
        np.testing.assert_allclose(pose[:3, 3], want[:3, 3], atol=1e-3, err_msg=f"scan {i}")
        np.testing.assert_allclose(pose[:3, :3], want[:3, :3], atol=1e-3, err_msg=f"scan {i}")
        flips = int((keep != pin[f"{tag}/keep"][i]).sum())
        assert flips <= 0.005 * sv.sum(), (i, flips)
        assert abs(int(st["inliers"]) - pin[f"{tag}/inliers"][i]) <= 0.01 * sv.sum()
        assert abs(int(st["n_kept"]) - pin[f"{tag}/n_kept"][i]) <= 0.005 * sv.sum()
        assert np.linalg.norm(pose[:3, 3] - gt[i][:3, 3]) < 0.3
    assert loop._i == len(scans) and loop._cache is not None


def test_invalidate_resets_state(setup):
    cfg, sd, scans, gt, mp, _ = setup
    loop = tloop.LocalizationLoop(cfg, sd, mp, refine=False, device="cpu")
    sx, sv, sl = _pad(scans[0], cfg.tpu.scan_points)
    loop(sx, sv, sl, prior=gt[0].astype(np.float32))
    assert loop._state is not None and loop._cache is not None
    loop.invalidate()
    assert loop._state is None and loop._cache is None and loop._i == 0


def _rand_pose(rng, rot=0.3, trans=1.0):
    w = rng.normal(0, rot, 3)
    th = np.linalg.norm(w)
    k = w / th
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0.0]])
    p = np.eye(4, dtype=np.float32)
    p[:3, :3] = np.eye(3) + np.sin(th) * kx + (1 - np.cos(th)) * kx @ kx
    p[:3, 3] = rng.normal(0, trans, 3)
    return p


@pytest.mark.parametrize("rot", [0.3, 1e-4, 0.0], ids=["turn", "small", "none"])
def test_se3_helpers_match_sps_tpu(rot):
    rng = np.random.default_rng(int(rot * 1e4) + 1)
    a, b = _rand_pose(rng, max(rot, 1e-30)), _rand_pose(rng, max(rot, 1e-30))
    if rot == 0.0:
        a[:3, :3] = b[:3, :3] = np.eye(3)
    np.testing.assert_allclose(tloop._se3_inv(torch.from_numpy(a)).numpy(),
                               np.asarray(jloop._se3_inv(jnp.asarray(a))), atol=1e-6)
    np.testing.assert_allclose(tloop._se3_log(torch.from_numpy(a)).numpy(),
                               np.asarray(jloop._se3_log(jnp.asarray(a))), atol=2e-6)
    hist = np.stack([a, b])
    np.testing.assert_allclose(tloop._cv_guess(torch.from_numpy(hist)).numpy(),
                               np.asarray(jloop._cv_guess(jnp.asarray(hist))), atol=2e-5)


def test_cv_guess_damps():
    """A constant step repeats at 0.85 of its length."""
    step = np.eye(4, dtype=np.float32)
    step[:3, 3] = [0.2, 0.0, 0.0]
    hist = torch.from_numpy(np.stack([np.eye(4, dtype=np.float32), step]))
    g = tloop._cv_guess(hist).numpy()
    np.testing.assert_allclose(g[:3, 3], [0.2 + 0.85 * 0.2, 0.0, 0.0], atol=1e-6)
