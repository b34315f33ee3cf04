"""sps_torch/register.py against sps_tpu/register.py on the same maps, scans
and poses (CPU, f32).

The port's voxel rows are in sorted-key order and sps_tpu's in hash order,
so everything is compared per point or per voxel key, never by row id.
Tolerances: centroids 1e-5 m; normals 1e-4 in |n . n'| (also on voxels of
one or two points, whose normal is set by the covariance's rounding: the
port rounds E[xx^T] - mu mu^T once, as XLA's fused multiply-add does);
distances 1e-6 m; poses 1e-4 (rotation) / 1e-4 m (translation): the normal equations are
summed in another order (one matmul against sps_tpu's 27 reductions)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sps_torch import register as treg
from sps_torch.data import synthetic
from sps_tpu import register as jreg

VOXEL = 0.4


def _pose(yaw, t):
    c, s = np.cos(yaw), np.sin(yaw)
    p = np.eye(4, dtype=np.float32)
    p[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    p[:3, 3] = t
    return p


@pytest.fixture(scope="module")
def world():
    w = synthetic.make_world(seed=1, extent=12.0, n_stable=14, ground_points=8000)
    assert len(w) <= 20000
    return w


@pytest.fixture(scope="module")
def maps(world):
    out = {}
    for lut in (True, False):
        out[lut] = (treg.build_voxel_map(world, VOXEL, lut=lut, device="cpu"),
                    jreg.build_voxel_map(world, VOXEL, lut=lut))
    return out


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


def test_build_voxel_map_per_voxel(maps):
    """Same voxel set; per voxel the same centroid and normal (looked up
    through sps_tpu's correspondence of the port's centroid, which lies in
    its own voxel at distance 0)."""
    vm_t, vm_j = maps[False]
    assert vm_t.num_voxels == int(vm_j.num_voxels)
    cent = vm_t.centroids.numpy()
    cj, nj, hj = jreg._correspond(vm_j, jnp.asarray(cent), jnp.ones(len(cent), bool))
    assert np.asarray(hj).all()
    np.testing.assert_allclose(np.asarray(cj), cent, atol=1e-5)
    dots = np.abs((np.asarray(nj) * vm_t.normals.numpy()).sum(-1))
    assert (dots > 1 - 1e-4).all(), np.sort(dots)[:5]
    np.testing.assert_allclose(np.linalg.norm(vm_t.normals.numpy(), axis=1), 1.0, atol=1e-4)


@pytest.mark.parametrize("lut", [True, False], ids=["lut", "probes"])
def test_correspond_per_point(world, maps, lut):
    vm_t, vm_j = maps[lut]
    p, v = _query(world)
    ct, nt, ht = treg._correspond(vm_t, torch.from_numpy(p), torch.from_numpy(v))
    cj, nj, hj = jreg._correspond(vm_j, jnp.asarray(p), jnp.asarray(v))
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    h = ht.numpy()
    assert 0.5 < h.mean() < 1.0
    np.testing.assert_allclose(ct.numpy()[h], np.asarray(cj)[h], atol=1e-5)
    dots = np.abs((nt.numpy()[h] * np.asarray(nj)[h]).sum(-1))
    # Same voxel (same centroid) on both sides; its normal as above.
    assert np.median(dots) > 1 - 1e-5


def test_lut_matches_sps_tpu_cell_for_cell(maps):
    """The LUT picks the same voxel per cell: compare the picked centroids."""
    vm_t, vm_j = maps[True]
    np.testing.assert_array_equal(vm_t.lut_dims.numpy(), np.asarray(vm_j.lut_dims))
    np.testing.assert_array_equal(vm_t.lut_origin.numpy(), np.asarray(vm_j.lut_origin))
    lt, lj = vm_t.lut.numpy()[:-1], np.asarray(vm_j.lut)
    np.testing.assert_array_equal(lt >= 0, lj >= 0)
    have = lt >= 0
    np.testing.assert_allclose(vm_t.centroids.numpy()[lt[have]],
                               np.asarray(vm_j.centroids)[lj[have]], atol=1e-5)
    assert vm_t.lut.numpy()[-1] == treg.EMPTY


def test_correspond_cols_per_point(world, maps):
    vm_t, vm_j = maps[True]
    p, v = _query(world, seed=2)
    cn_t = torch.cat([vm_t.centroids, vm_t.normals], -1)
    cn_j = jnp.concatenate([vm_j.centroids, vm_j.normals], -1)
    rows_t, ht = treg._correspond_cols(vm_t, cn_t, torch.from_numpy(p), torch.from_numpy(v))
    cols_j, hj = jreg._correspond_cols(vm_j, cn_j, *(jnp.asarray(p[:, i]) for i in range(3)),
                                       jnp.asarray(v))
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    h = ht.numpy()
    cj = np.stack([np.asarray(c) for c in cols_j], -1)[h]
    rt = rows_t.numpy()[h]
    np.testing.assert_allclose(rt[:, :3], cj[:, :3], atol=1e-5)
    assert (np.abs((rt[:, 3:] * cj[:, 3:]).sum(-1)) > 1 - 1e-4).all()


@pytest.mark.parametrize("lut", [True, False], ids=["lut", "probes"])
def test_point_map_distance(world, maps, lut):
    vm_t, vm_j = maps[lut]
    p, v = _query(world, seed=3)
    dt = treg.point_map_distance(vm_t, torch.from_numpy(p), torch.from_numpy(v), cap=1.0).numpy()
    dj = np.asarray(jreg.point_map_distance(vm_j, jnp.asarray(p), jnp.asarray(v), cap=1.0))
    assert dt.dtype == np.float32
    np.testing.assert_allclose(dt, dj, rtol=0, atol=1e-6)
    assert (dt[~v] == 0).all() and (dt[v] == 1.0).any() and (dt[v] < 1.0).any()


def test_yaw_search(world, maps):
    vm_t, vm_j = maps[True]
    scan, valid, true_pose = _scan(world)
    guess = _pose(0.3 + 0.3, [1.5, -0.8, 0.1])  # the truth is one of the 13 yaws
    pt = treg.yaw_search(vm_t, torch.from_numpy(scan), torch.from_numpy(valid),
                         torch.from_numpy(guess)).numpy()
    pj = np.asarray(jreg.yaw_search(vm_j, jnp.asarray(scan), jnp.asarray(valid),
                                    jnp.asarray(guess)))
    np.testing.assert_allclose(pt, pj, atol=1e-5)
    assert not np.allclose(pt, guess, atol=1e-3)


@pytest.mark.parametrize("lut", [True, False], ids=["lut", "probes"])
def test_register(world, maps, lut):
    vm_t, vm_j = maps[lut]
    scan, valid, true_pose = _scan(world)
    guess = _pose(0.3 + 0.06, [1.5 + 0.25, -0.8 - 0.2, 0.1])
    pt, st = treg.register(vm_t, torch.from_numpy(scan), torch.from_numpy(valid),
                           torch.from_numpy(guess), iters=20)
    pj, sj = jax.jit(lambda s, v, p: jreg.register(vm_j, s, v, p, iters=20))(
        jnp.asarray(scan), jnp.asarray(valid), jnp.asarray(guess))
    pt, pj = pt.numpy(), np.asarray(pj)
    np.testing.assert_allclose(pt[:3, :3], pj[:3, :3], atol=1e-4)
    np.testing.assert_allclose(pt[:3, 3], pj[:3, 3], atol=1e-4)
    assert int(st["inliers"]) == int(sj["inliers"])
    np.testing.assert_allclose(float(st["rmse"]), float(sj["rmse"]), rtol=1e-3)
    assert np.linalg.norm(pt[:3, 3] - true_pose[:3, 3]) < 0.08


@pytest.fixture(scope="module")
def pyramid(world):
    return (tuple(treg.build_voxel_map(world, v, device="cpu") for v in (1.6, VOXEL)),
            tuple(jreg.build_voxel_map(world, v) for v in (1.6, VOXEL)))


@pytest.mark.parametrize("start", [0, 1], ids=["shifted", "turned"])
def test_register_pyramid(world, pyramid, start):
    """Two levels (coarse 1.6 m, fine 0.4 m) with the yaw search, from a
    shifted and from a turned start; with per-point weights on the second."""
    vms_t, vms_j = pyramid
    scan, valid, true_pose = _scan(world, seed=4)
    guess = (_pose(0.3 + 0.05, [1.5 + 0.6, -0.8 - 0.5, 0.1]) if start == 0
             else _pose(0.3 + 0.3, [1.5 + 0.1, -0.8, 0.1]))
    w = None
    if start == 1:
        w = np.random.default_rng(5).uniform(0.2, 1.0, len(scan)).astype(np.float32)
    pt, st = treg.register_pyramid(vms_t, torch.from_numpy(scan), torch.from_numpy(valid),
                                   torch.from_numpy(guess),
                                   point_w=None if w is None else torch.from_numpy(w))
    pj, sj = jax.jit(lambda vms, s, v, p, pw: jreg.register_pyramid(vms, s, v, p, point_w=pw))(
        vms_j, jnp.asarray(scan), jnp.asarray(valid), jnp.asarray(guess),
        None if w is None else jnp.asarray(w))
    pt, pj = pt.numpy(), np.asarray(pj)
    np.testing.assert_allclose(pt[:3, :3], pj[:3, :3], atol=1e-4)
    np.testing.assert_allclose(pt[:3, 3], pj[:3, 3], atol=1e-4)
    assert int(st["inliers"]) == int(sj["inliers"])
    assert np.linalg.norm(pt[:3, 3] - true_pose[:3, 3]) < 0.08


def test_smallest_evec_against_eigh():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(256, 3, 3)).astype(np.float32)
    scale = np.array([1.0, 0.3, 0.01], np.float32)
    q, _ = np.linalg.qr(a)
    cov = (q * scale[None, None, :]) @ q.transpose(0, 2, 1)
    v = treg._smallest_evec(torch.from_numpy(cov.astype(np.float32))).numpy()
    _, evecs = np.linalg.eigh(cov.astype(np.float64))
    dots = np.abs((v * evecs[:, :, 0]).sum(-1))
    assert (dots > 1 - 1e-5).all(), dots.min()
    vj = np.asarray(jreg._smallest_evec(jnp.asarray(cov)))
    np.testing.assert_allclose(np.abs((v * vj).sum(-1)), 1.0, atol=1e-5)


def test_exp_se3_matches():
    rng = np.random.default_rng(1)
    for _ in range(5):
        d = rng.normal(0, 0.2, 6).astype(np.float32)
        np.testing.assert_allclose(treg._exp_se3(torch.from_numpy(d)).numpy(),
                                   np.asarray(jreg._exp_se3(jnp.asarray(d))), atol=1e-6)
