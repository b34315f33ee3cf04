"""The port's dataset generators and loader, and run_localization,
against sps_tpu's (CPU).

generate() and generate_dense() write the same files bit for bit from the
same seed; the loaders return the same arrays. run_localization with the
"raw" and "oracle" filters (no network) on a small dense world with
growth and movers: per-scan poses within 1e-3 m (the ICP's sums are taken
in another order; tests/test_torch_register.py holds single registrations
within 1e-4), ATE within 1e-3 m, kept fractions equal. cv_predict and
ate_rmse are the same numpy code on both sides. The "sps-soft" filter is in
tests/test_torch_localize_soft.py, the baselines in
tests/test_torch_localize_baselines.py."""

import filecmp
import os

import jax
import numpy as np
import pytest

import sps_torch.config as tcfg_mod
import sps_tpu.config as jcfg_mod
from sps_torch.data import blt as tblt
from sps_torch.data import synthetic as tsyn
from sps_torch.stream import localize as tloc
from sps_tpu import register as jreg
from sps_tpu.data import blt as jblt
from sps_tpu.data import synthetic as jsyn
from sps_tpu.stream import localize as jloc

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DENSE = dict(sequences=("20220608", "20220629", "20220629_clean"), scans_per_seq=6, seed=2,
             extent=8.0, n_stable=8, map_density=60.0, scan_density=6.0, clutter_boxes=4,
             growth_boxes=2, mover_boxes=2, clean_sequences=("20220629_clean",))
SPARSE = dict(sequences=("20220629",), scans_per_seq=3, seed=3, extent=10.0, n_rays=400,
              ground_points=6000, n_stable=10)


def _same_tree(a, b):
    files = []
    for d, _, names in os.walk(a):
        files += [os.path.relpath(os.path.join(d, n), a) for n in names]
    other = []
    for d, _, names in os.walk(b):
        other += [os.path.relpath(os.path.join(d, n), b) for n in names]
    assert sorted(files) == sorted(other)
    _, mismatch, errors = filecmp.cmpfiles(a, b, files, shallow=False)
    assert not mismatch and not errors, mismatch[:5]
    return files


@pytest.fixture(scope="module")
def dense(tmp_path_factory):
    a, b = str(tmp_path_factory.mktemp("dense_t")), str(tmp_path_factory.mktemp("dense_j"))
    tsyn.generate_dense(a, **DENSE)
    jsyn.generate_dense(b, **DENSE)
    return a, b


def test_generate_dense_writes_the_same_files(dense):
    files = _same_tree(*dense)
    assert len(files) == 1 + 3 * (1 + 2 * DENSE["scans_per_seq"])


def test_generate_writes_the_same_files(tmp_path):
    a, b = str(tmp_path / "t"), str(tmp_path / "j")
    tsyn.generate(a, **SPARSE)
    jsyn.generate(b, **SPARSE)
    assert len(_same_tree(a, b)) == 1 + 1 + 2 * SPARSE["scans_per_seq"]


def test_movers_recipe_is_the_config_header():
    head = open(os.path.join(_ROOT, "config", "config_loc_movers.yaml")).read().split("EXPERIMENT")[0]
    for flag, key in (("--extent", "extent"), ("--n-stable", "n_stable"),
                      ("--map-density", "map_density"), ("--scan-density", "scan_density"),
                      ("--clutter-boxes", "clutter_boxes"), ("--growth-boxes", "growth_boxes"),
                      ("--mover-boxes", "mover_boxes")):
        assert f"{flag} {tsyn.MOVERS[key]:g}" in head, flag
    assert ",".join(tsyn.MOVERS["sequences"]) in head
    assert f"--clean-sequences {tsyn.MOVERS['clean_sequences'][0]}" in head


def test_loaders_match_sps_tpu(dense):
    root = dense[0]
    seqs = ["20220629", "20220608"]
    st, pt = tblt.load_sequences_raw(root, seqs)
    sj, pj = jblt.load_sequences_raw(root, seqs)
    assert len(st) == len(sj) == 2 * DENSE["scans_per_seq"]
    for a, b in zip(st, sj):
        assert a.dtype == np.float32 and a.flags.c_contiguous
        np.testing.assert_array_equal(a, b)
    for a, b in zip(pt, pj):
        np.testing.assert_array_equal(a, b)
    ft, qt = tblt.sequence_files(root, "20220629")
    fj, qj = jblt.sequence_files(root, "20220629")
    assert ft == fj
    for a, b in zip(qt, qj):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    mt, mj = tblt.load_map(root, "base_map.asc.npy"), jblt.load_map(root, "base_map.asc.npy")
    assert mt.dtype == np.float32 and mt.shape[1] == 3
    np.testing.assert_array_equal(mt, mj)


def test_ate_and_cv_predict_match_sps_tpu():
    rng = np.random.default_rng(0)
    poses = []
    for i in range(6):
        p = np.eye(4)
        a = 0.1 * i + rng.normal(0, 0.01)
        p[:3, :3] = [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]]
        p[:3, 3] = [i * 0.5, 0.1 * i * i, rng.normal(0, 0.01)]
        poses.append(p)
    for k in range(len(poses) + 1):
        np.testing.assert_allclose(tloc.cv_predict(poses[:k]), jloc.cv_predict(poses[:k]),
                                   atol=1e-12)
    est, gt = np.stack(poses), np.stack(poses[::-1])
    assert tloc.ate_rmse(est, gt) == jloc.ate_rmse(est, gt)
    x = rng.normal(0, 0.2, 6)
    np.testing.assert_allclose(tloc._se3_log_np(tloc._se3_exp_np(x)), x, atol=1e-12)


def _run_jax(cfg, variables, seq, mode, **kw):
    """sps_tpu's run_localization, with each scan's final pose captured
    (its result keeps only the ATE)."""
    last, poses = {}, []
    reg_jit = jax.jit(lambda vms, s, v, p, w: jreg.register_pyramid(vms, s, v, p, iters=12,
                                                                    point_w=w))

    def reg_fn(vms, s, v, p, w=None):
        pose, stats = reg_jit(vms, s, v, p, w)
        last["pose"] = np.asarray(pose)
        return pose, stats

    r = jloc.run_localization(cfg, variables, seq, mode,
                              cache={"reg_fn": reg_fn, "reg_fn_w": reg_fn},
                              log=lambda _m: poses.append(last["pose"]), **kw)
    return r, np.stack(poses)


@pytest.mark.parametrize("mode,kw", [
    ("raw", dict(prior="cv", init_noise=0.05, seed=1)),
    ("oracle", dict(prior="odom", init_noise=0.05, seed=0)),
], ids=["raw-cv", "oracle-odom"])
def test_run_localization_matches_sps_tpu(dense, mode, kw):
    root = dense[0]
    path = os.path.join(_ROOT, "config", "config_small.yaml")
    got = tloc.run_localization(tcfg_mod.load(path, data_root=root), {}, "20220629", mode,
                                log=lambda _m: None, device="cpu", **kw)
    want, poses = _run_jax(jcfg_mod.load(path, data_root=root), None, "20220629", mode, **kw)
    check_run(got, want, poses, DENSE["scans_per_seq"], kept_tol=1e-12)
    assert got["ate_rmse"] < 0.1


def check_run(got, want, poses, n_scans, kept_tol):
    assert got["poses"].shape == poses.shape == (n_scans, 4, 4)
    np.testing.assert_allclose(got["poses"][:, :3, 3], poses[:, :3, 3], atol=1e-3)
    np.testing.assert_allclose(got["poses"][:, :3, :3], poses[:, :3, :3], atol=1e-3)
    assert abs(got["ate_rmse"] - want["ate_rmse"]) <= 1e-3
    assert got["kept_frac_mean"] == pytest.approx(want["kept_frac_mean"], abs=kept_tol)
    for key in ("filter", "n_scans", "prior", "epsilon", "init_noise", "refine", "icp_iters",
                "seed", "cv_raw_first"):
        assert got[key] == want[key], key
