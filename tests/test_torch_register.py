"""sps_torch/register.py against sps_tpu/register.py on the same maps, scans
and poses (CPU, f32).

sps_tpu's results on this file's inputs (cases()) are pinned by
scripts/export_torch_assets.py --only register
(sps_torch/assets/register_pin.npz); the pin records its inputs and
sps_tpu_results checks them against this file's own.

The port's voxel rows are in sorted-key order and sps_tpu's in hash order,
so everything is compared per point or per voxel key, never by row id.
Tolerances: centroids 1e-5 m; normals 1e-4 in |n . n'| (also on voxels of
one or two points, whose normal is set by the covariance's rounding: the
port rounds E[xx^T] - mu mu^T once, as XLA's fused multiply-add does);
distances 1e-6 m; poses 1e-4 (rotation) / 1e-4 m (translation): the normal equations are
summed in another order (one matmul against sps_tpu's 27 reductions)."""

import numpy as np
import pytest
import torch
from test_torch_stream import pinned

from sps_torch import register as treg
from sps_torch.data import synthetic
from sps_torch.data.bench_world import fingerprint

VOXEL = 0.4
LUTS = {"lut": True, "probes": False}


def _pose(yaw, t):
    c, s = np.cos(yaw), np.sin(yaw)
    p = np.eye(4, dtype=np.float32)
    p[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    p[:3, 3] = t
    return p


def make_world():
    w = synthetic.make_world(seed=1, extent=12.0, n_stable=14, ground_points=8000)
    assert len(w) <= 20000
    return w


@pytest.fixture(scope="module")
def world():
    return make_world()


@pytest.fixture(scope="module")
def maps(world):
    return {lut: treg.build_voxel_map(world, VOXEL, lut=lut, device="cpu")
            for lut in (True, False)}


def _scan(world, seed=0, n=4000):
    rng = np.random.default_rng(seed)
    sel = rng.choice(len(world), n, replace=False)
    pts_world = world[sel] + rng.normal(0, 0.01, (n, 3)).astype(np.float32)
    true_pose = _pose(0.3, [1.5, -0.8, 0.1])
    inv = np.linalg.inv(true_pose)
    scan = (pts_world @ inv[:3, :3].T + inv[:3, 3]).astype(np.float32)
    valid = rng.random(n) < 0.95
    return scan, valid, true_pose


def _query(world, seed=1, n=3000):
    """Points near the map (within a few voxels) and some far outside it."""
    rng = np.random.default_rng(seed)
    near = world[rng.choice(len(world), n, replace=False)]
    near = near + rng.normal(0, 0.3, near.shape).astype(np.float32)
    far = rng.uniform(-40, 40, (200, 3)).astype(np.float32)
    p = np.concatenate([near, far]).astype(np.float32)
    return p, rng.random(len(p)) < 0.9


def _cov():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(256, 3, 3)).astype(np.float32)
    scale = np.array([1.0, 0.3, 0.01], np.float32)
    q, _ = np.linalg.qr(a)
    return ((q * scale[None, None, :]) @ q.transpose(0, 2, 1)).astype(np.float32)


def _se3_deltas():
    rng = np.random.default_rng(1)
    return [rng.normal(0, 0.2, 6).astype(np.float32) for _ in range(5)]


def _pyramid_case(world, start):
    scan, valid, true_pose = _scan(world, seed=4)
    guess = (_pose(0.3 + 0.05, [1.5 + 0.6, -0.8 - 0.5, 0.1]) if start == 0
             else _pose(0.3 + 0.3, [1.5 + 0.1, -0.8, 0.1]))
    w = None
    if start == 1:
        w = np.random.default_rng(5).uniform(0.2, 1.0, len(scan)).astype(np.float32)
    return scan, valid, true_pose, guess, w


def cases(world):
    """Every input this file hands both packages, by name."""
    scan, valid, _ = _scan(world)
    out = {"query1": _query(world), "query2": _query(world, seed=2),
           "query3": _query(world, seed=3),
           "yaw": (scan, valid, _pose(0.3 + 0.3, [1.5, -0.8, 0.1])),
           "register": (scan, valid, _pose(0.3 + 0.06, [1.5 + 0.25, -0.8 - 0.2, 0.1])),
           "cov": (_cov(),), "se3": tuple(_se3_deltas())}
    for start in (0, 1):
        scan, valid, _, guess, w = _pyramid_case(world, start)
        out[f"pyramid{start}"] = (scan, valid, guess) + (() if w is None else (w,))
    return out


def pin_record(world):
    """What register_pin.npz records of its inputs."""
    return {"voxel": VOXEL, "world": fingerprint(world),
            "cases": {k: [fingerprint(a) for a in v] for k, v in cases(world).items()}}


@pytest.fixture(scope="module")
def sps_tpu_results(world):
    """sps_tpu's maps and results on cases(), as pinned."""
    return pinned("register_pin.npz", "register", pin_record(world))


def _nearest_of_27(cj, nj, p):
    """sps_tpu's probing correspondence (lut=False) on its pinned voxels:
    per point the nearest centroid among the 27 voxels around the point's
    own, and whether there was one."""
    row = {tuple(k): i for i, k in enumerate(np.floor(cj / np.float32(VOXEL)).astype(np.int64))}
    offs = np.stack(np.meshgrid(*[np.arange(-1, 2)] * 3, indexing="ij"), -1).reshape(27, 3)
    c, n, h = np.zeros_like(p), np.zeros_like(p), np.zeros(len(p), bool)
    for i, k in enumerate(np.floor(p / np.float32(VOXEL)).astype(np.int64)):
        rows = [row[key] for key in map(tuple, k + offs) if key in row]
        if rows:
            best = rows[int(np.argmin(((cj[rows] - p[i]) ** 2).sum(-1)))]
            c[i], n[i], h[i] = cj[best], nj[best], True
    return c, n, h


def test_build_voxel_map_per_voxel(maps, sps_tpu_results):
    """Same voxel set; per voxel the same centroid and normal (looked up
    through sps_tpu's correspondence of the port's centroid, which lies in
    its own voxel at distance 0)."""
    vm_t, pin = maps[False], sps_tpu_results
    assert vm_t.num_voxels == int(pin["probes/num_voxels"])
    cent = vm_t.centroids.numpy()
    cj, nj, hj = _nearest_of_27(pin["probes/centroids"], pin["probes/normals"], cent)
    assert hj.all()
    np.testing.assert_allclose(cj, cent, atol=1e-5)
    dots = np.abs((nj * vm_t.normals.numpy()).sum(-1))
    assert (dots > 1 - 1e-4).all(), np.sort(dots)[:5]
    np.testing.assert_allclose(np.linalg.norm(vm_t.normals.numpy(), axis=1), 1.0, atol=1e-4)


@pytest.mark.parametrize("lut", LUTS)
def test_correspond_per_point(world, maps, sps_tpu_results, lut):
    vm_t, pin = maps[LUTS[lut]], sps_tpu_results
    p, v = cases(world)["query1"]
    ct, nt, ht = treg._correspond(vm_t, torch.from_numpy(p), torch.from_numpy(v))
    cj, nj, hj = (pin[f"{lut}/correspond/{k}"] for k in "cnh")
    np.testing.assert_array_equal(ht.numpy(), hj)
    h = ht.numpy()
    assert 0.5 < h.mean() < 1.0
    np.testing.assert_allclose(ct.numpy()[h], cj[h], atol=1e-5)
    dots = np.abs((nt.numpy()[h] * nj[h]).sum(-1))
    # Same voxel (same centroid) on both sides; its normal as above.
    assert np.median(dots) > 1 - 1e-5


def test_lut_matches_sps_tpu_cell_for_cell(maps, sps_tpu_results):
    """The LUT picks the same voxel per cell: compare the picked centroids."""
    vm_t, pin = maps[True], sps_tpu_results
    np.testing.assert_array_equal(vm_t.lut_dims.numpy(), pin["lut/lut_dims"])
    np.testing.assert_array_equal(vm_t.lut_origin.numpy(), pin["lut/lut_origin"])
    lt, lj = vm_t.lut.numpy()[:-1], pin["lut/lut"]
    np.testing.assert_array_equal(lt >= 0, lj >= 0)
    have = lt >= 0
    np.testing.assert_allclose(vm_t.centroids.numpy()[lt[have]],
                               pin["lut/centroids"][lj[have]], atol=1e-5)
    assert vm_t.lut.numpy()[-1] == treg.EMPTY


def test_correspond_cols_per_point(world, maps, sps_tpu_results):
    vm_t, pin = maps[True], sps_tpu_results
    p, v = cases(world)["query2"]
    cn_t = torch.cat([vm_t.centroids, vm_t.normals], -1)
    rows_t, ht = treg._correspond_cols(vm_t, cn_t, torch.from_numpy(p), torch.from_numpy(v))
    np.testing.assert_array_equal(ht.numpy(), pin["cols/h"])
    h = ht.numpy()
    cj = pin["cols/c"][h]
    rt = rows_t.numpy()[h]
    np.testing.assert_allclose(rt[:, :3], cj[:, :3], atol=1e-5)
    assert (np.abs((rt[:, 3:] * cj[:, 3:]).sum(-1)) > 1 - 1e-4).all()


@pytest.mark.parametrize("lut", LUTS)
def test_point_map_distance(world, maps, sps_tpu_results, lut):
    vm_t = maps[LUTS[lut]]
    p, v = cases(world)["query3"]
    dt = treg.point_map_distance(vm_t, torch.from_numpy(p), torch.from_numpy(v), cap=1.0).numpy()
    dj = sps_tpu_results[f"{lut}/distance"]
    assert dt.dtype == np.float32
    np.testing.assert_allclose(dt, dj, rtol=0, atol=1e-6)
    assert (dt[~v] == 0).all() and (dt[v] == 1.0).any() and (dt[v] < 1.0).any()


def test_yaw_search(world, maps, sps_tpu_results):
    vm_t = maps[True]
    scan, valid, guess = cases(world)["yaw"]  # the truth is one of the 13 yaws
    pt = treg.yaw_search(vm_t, torch.from_numpy(scan), torch.from_numpy(valid),
                         torch.from_numpy(guess)).numpy()
    np.testing.assert_allclose(pt, sps_tpu_results["yaw/pose"], atol=1e-5)
    assert not np.allclose(pt, guess, atol=1e-3)


@pytest.mark.parametrize("lut", LUTS)
def test_register(world, maps, sps_tpu_results, lut):
    vm_t, pin = maps[LUTS[lut]], sps_tpu_results
    scan, valid, guess = cases(world)["register"]
    true_pose = _scan(world)[2]
    pt, st = treg.register(vm_t, torch.from_numpy(scan), torch.from_numpy(valid),
                           torch.from_numpy(guess), iters=20)
    pt, pj = pt.numpy(), pin[f"{lut}/register/pose"]
    np.testing.assert_allclose(pt[:3, :3], pj[:3, :3], atol=1e-4)
    np.testing.assert_allclose(pt[:3, 3], pj[:3, 3], atol=1e-4)
    assert int(st["inliers"]) == int(pin[f"{lut}/register/inliers"])
    np.testing.assert_allclose(float(st["rmse"]), float(pin[f"{lut}/register/rmse"]), rtol=1e-3)
    assert np.linalg.norm(pt[:3, 3] - true_pose[:3, 3]) < 0.08


@pytest.fixture(scope="module")
def pyramid(world):
    return tuple(treg.build_voxel_map(world, v, device="cpu") for v in (1.6, VOXEL))


@pytest.mark.parametrize("start", [0, 1], ids=["shifted", "turned"])
def test_register_pyramid(world, pyramid, sps_tpu_results, start):
    """Two levels (coarse 1.6 m, fine 0.4 m) with the yaw search, from a
    shifted and from a turned start; with per-point weights on the second."""
    scan, valid, true_pose, guess, w = _pyramid_case(world, start)
    pt, st = treg.register_pyramid(pyramid, torch.from_numpy(scan), torch.from_numpy(valid),
                                   torch.from_numpy(guess),
                                   point_w=None if w is None else torch.from_numpy(w))
    pt, pj = pt.numpy(), sps_tpu_results[f"pyramid{start}/pose"]
    np.testing.assert_allclose(pt[:3, :3], pj[:3, :3], atol=1e-4)
    np.testing.assert_allclose(pt[:3, 3], pj[:3, 3], atol=1e-4)
    assert int(st["inliers"]) == int(sps_tpu_results[f"pyramid{start}/inliers"])
    assert np.linalg.norm(pt[:3, 3] - true_pose[:3, 3]) < 0.08


def test_smallest_evec_against_eigh(sps_tpu_results):
    cov = _cov()
    v = treg._smallest_evec(torch.from_numpy(cov)).numpy()
    _, evecs = np.linalg.eigh(cov.astype(np.float64))
    dots = np.abs((v * evecs[:, :, 0]).sum(-1))
    assert (dots > 1 - 1e-5).all(), dots.min()
    np.testing.assert_allclose(np.abs((v * sps_tpu_results["evec"]).sum(-1)), 1.0, atol=1e-5)


def test_exp_se3_matches(sps_tpu_results):
    for d, want in zip(_se3_deltas(), sps_tpu_results["se3"]):
        np.testing.assert_allclose(treg._exp_se3(torch.from_numpy(d)).numpy(), want, atol=1e-6)
