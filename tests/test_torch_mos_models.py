"""The port's MOS4D and MapMOS networks (sps_torch/models/{mos4d,mapmos}.py)
and the atlas voxelizer's pooled features against sps_tpu's (CPU).

Seeded weights (the port's MinkUNet init with random BN statistics,
carried to flax by name) on seeded points at voxel 0.25, test_baselines.py's
CAPS with the brick capacities cut to 64 a level and the atlas window to
(1, 6, 6, 6) bricks (the points span 3 bricks an axis; test_baselines.py's
512-brick levels take ~8 s a forward on the CPU), both models and the
pooled voxelization in one JAX program:
  * MapMOSNet (f32): logits within rtol 1e-3 / atol 1e-4, the port's f32
    model tolerance (the same network, sums in another order).
  * MOS4DNet (T = 4): sps_tpu feeds MinkUNet the bf16 occupancy (0.5 * occ),
    so the whole network computes in bf16, and the port does the same.
    Logits within 2^-6 of the largest |logit| (two bf16 ulps at that
    scale); decisions (logit > 0) equal except within that band of 0.
  * voxelize_bricks(features=...): the grid (occupancy, coords, atlas,
    count) and point2slot bit-equal, pooled means within 1e-6 of sps_tpu's
    and of a numpy group-mean, and the slots with a point exactly the
    occupied ones.
  * normalized_index_features: 1 + (i_max - i) / (i_max - i_min) over the
    valid points, 1 when all are equal, equal to sps_tpu's.
  * The ME layout: state_dict_from_me strips both reference prefixes
    (model.MinkUNet. for SPS and MOS4D, mos.MinkUNet. for MapMOS) and
    equals sps_tpu's variables_from_state_dict on synthetic MOS4D
    (out = 3) and MapMOS state dicts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_stream import _flax_tree

from sps_torch import convert as tconv
from sps_torch.models import mapmos as tmm
from sps_torch.models import mos4d as tm4
from sps_torch.models.minkunet import MaskedBatchNorm
from sps_torch.ops import atlas as tatl
from sps_torch.ops import voxelize as tvox
from sps_torch.structs import Capacities as TCaps
from sps_torch.structs import pad_point_batch as tpad
from sps_tpu import convert as jconv
from sps_tpu.models import mapmos as jmm
from sps_tpu.models import mos4d as jm4
from sps_tpu.ops import atlas as jatl
from sps_tpu.ops import voxelize as jvox
from sps_tpu.structs import Capacities as JCaps
from sps_tpu.structs import pad_point_batch as jpad

CAPS = dict(points=1024, voxels=(1024, 512, 256, 256, 256), bricks=(64,) * 5)
CFG = dict(voxel_size=0.25, atlas_extent=(1, 6, 6, 6))
N = 300


def _seeded(model, seed):
    g = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, MaskedBatchNorm):
                m.mean.copy_(0.3 * torch.randn(m.features, generator=g))
                m.var.copy_(0.5 + torch.rand(m.features, generator=g))
    return model.eval()


def _points(seed, t_vals):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-3, 3, (N, 3)).astype(np.float32)
    t = rng.choice(t_vals, size=N)
    args = (xyz, np.zeros(N, np.int32), t, np.zeros(N, np.float32), CAPS["points"])
    return jpad(*args), tpad(*args, device="cpu")


@pytest.fixture(scope="module")
def runs():
    """Both models, port and sps_tpu, on their seeded inputs."""
    m4 = _seeded(tm4.MOS4DNet(tm4.MOS4DConfig(n_scans=4, caps=TCaps(**CAPS), **CFG),
                              torch.Generator().manual_seed(0)), 0)
    mm = _seeded(tmm.MapMOSNet(tmm.MapMOSConfig(caps=TCaps(**CAPS), **CFG),
                               torch.Generator().manual_seed(1)), 1)
    j4, t4 = _points(0, [0, 1, 2, 3])
    jm, tmp = _points(1, [0, 1])
    idx = np.zeros(CAPS["points"], np.float32)
    idx[:N] = np.where(np.asarray(tmp.t[:N]) == 1, 10, -1)
    v4 = jax.tree.map(np.asarray, _flax_tree(m4.state_dict()))
    vm = jax.tree.map(np.asarray, _flax_tree(mm.state_dict()))
    jn4 = jm4.MOS4DNet(jm4.MOS4DConfig(n_scans=4, caps=JCaps(**CAPS), **CFG))
    jnm = jmm.MapMOSNet(jmm.MapMOSConfig(caps=JCaps(**CAPS), **CFG))

    pool = _pool_inputs()

    @jax.jit
    def programs(v4, b4, vm, bm, i, pool):
        xyz, t, valid, feats = pool
        n = xyz.shape[0]
        vb = jatl.voxelize_bricks(jvox.quantize(xyz, 0.25), jnp.zeros(n, jnp.int32), t, valid,
                                  features=feats, **POOL)
        return jn4.apply(v4, b4)[0], jnm.apply(vm, bm, i)[0], vb

    w4, wm, vb = programs(v4, j4, vm, jm, jnp.asarray(idx), pool)
    with torch.no_grad():
        g4, a4 = m4(t4)
        gm, am = mm(tmp, torch.as_tensor(idx))
    assert not a4["overflow"].any() and not am["overflow"].any()
    return {"mos4d": (g4.numpy(), np.asarray(w4), t4), "mapmos": (gm.numpy(), np.asarray(wm), tmp),
            "pool": (pool, jax.tree.map(np.asarray, vb))}


def test_mapmos_logits_match_sps_tpu(runs):
    got, want, pb = runs["mapmos"]
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    valid = pb.valid.numpy()
    assert (got[~valid] == 0).all() and np.abs(got[valid]).max() > 0.1


def test_mos4d_logits_match_sps_tpu_in_bf16(runs):
    got, want, pb = runs["mos4d"]
    valid = pb.valid.numpy()
    band = 2.0**-6 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=band)
    far = np.abs(want) > band
    np.testing.assert_array_equal((got > 0)[far], (want > 0)[far])
    assert (got[~valid] == 0).all() and far[valid].mean() > 0.9
    # All four time slots were occupied and scored.
    assert set(np.unique(pb.t.numpy()[valid])) == {0, 1, 2, 3}


POOL = dict(num_time=2, brick_capacity=64, brick_side=8, extent=(1, 6, 6, 6))


def _pool_inputs(n=900):
    rng = np.random.default_rng(5)
    xyz = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    xyz[:300] = xyz[300:600] + rng.normal(0, 0.02, (300, 3)).astype(np.float32)  # shared voxels
    t = rng.integers(0, 2, n).astype(np.int32)
    valid = rng.random(n) < 0.9
    feats = rng.normal(size=(n, 3)).astype(np.float32)
    return xyz, t, valid, feats


def test_pooled_features_match_sps_tpu(runs):
    (xyz, t, valid, feats), (jg, jp2s, jpool) = runs["pool"]
    n = len(xyz)
    kw = POOL
    coords = tvox.quantize(torch.as_tensor(xyz), 0.25)
    tg, tp2s, tpool = tatl.voxelize_bricks(
        coords, torch.zeros(n, dtype=torch.int32), torch.as_tensor(t), torch.as_tensor(valid),
        features=torch.as_tensor(feats), **kw)
    for name in ("coords", "num_bricks", "atlas", "origin", "overflow"):
        np.testing.assert_array_equal(getattr(tg, name).numpy(), np.asarray(getattr(jg, name)))
    np.testing.assert_array_equal(tg.occ.float().numpy(), np.asarray(jg.occ, np.float32))
    np.testing.assert_array_equal(tp2s.numpy(), np.asarray(jp2s))
    assert tpool.shape == (64, 8, 8, 8, 2 * 3) and tpool.dtype == torch.float32
    np.testing.assert_allclose(tpool.numpy(), np.asarray(jpool), rtol=0, atol=1e-6)
    # A numpy group-mean over (slot, t) of the points with a slot.
    p2s = tp2s.numpy()
    ok = p2s >= 0
    key = p2s[ok].astype(np.int64) * 2 + t[ok]
    cnt = np.zeros(64 * 512 * 2)
    sums = np.zeros((64 * 512 * 2, 3))
    np.add.at(cnt, key, 1)
    np.add.at(sums, key, feats[ok].astype(np.float64))
    mean = (sums / np.maximum(cnt, 1)[:, None]).reshape(64, 8, 8, 8, 6)
    np.testing.assert_allclose(tpool.numpy(), mean, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(cnt.reshape(64, 8, 8, 8, 2) > 0, tg.occ.float().numpy() > 0)
    assert cnt.max() >= 2 and (~valid).any()
    # Without features the call returns what the shipping path reads.
    g2, p2 = tatl.voxelize_bricks(coords, torch.zeros(n, dtype=torch.int32), torch.as_tensor(t),
                                  torch.as_tensor(valid), **kw)
    assert torch.equal(g2.occ, tg.occ) and torch.equal(p2, tp2s)


def test_normalized_index_features():
    rng = np.random.default_rng(2)
    idx = rng.integers(-1, 12, 200).astype(np.float32)
    valid = rng.random(200) < 0.8
    idx[~valid] = 1e6  # ignored
    got = tmm.normalized_index_features(torch.as_tensor(idx), torch.as_tensor(valid))
    want = jmm.normalized_index_features(jnp.asarray(idx), jnp.asarray(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-7)
    v = idx[valid]
    np.testing.assert_allclose(got.numpy()[valid, 0], 1 + (v.max() - v) / (v.max() - v.min()),
                               rtol=1e-6)
    same = tmm.normalized_index_features(torch.full((50,), 7.0), torch.ones(50, dtype=torch.bool))
    assert (same == 1).all()


def _me_state_dict(rng, prefix, out_channels):
    """A synthetic reference MinkUNet14 state_dict in ME's layout."""
    sd = {}
    u = tm4.MOS4DConfig().sps_config().unet
    p, d0 = u.planes, u.init_dim

    def conv(name, k, cin, cout):
        sd[f"{prefix}{name}.kernel"] = rng.normal(size=(k, cin, cout)).astype(np.float32)

    def bn(name, c):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            sd[f"{prefix}{name}.bn.{leaf}"] = rng.random(c).astype(np.float32)
        sd[f"{prefix}{name}.bn.num_batches_tracked"] = np.zeros((), np.int64)

    conv("conv0p1s1", 125, 1, d0)
    bn("bn0", d0)
    chans = [(d0, d0), (p[0], p[0]), (p[1], p[1]), (p[2], p[2])]
    for i, (cin, cout) in enumerate(chans, 1):
        conv(f"conv{i}p{2**(i-1)}s2", 8, cin, cout)
        bn(f"bn{i}", cout)
    ups = [(p[3], p[4]), (p[4], p[5]), (p[5], p[6]), (p[6], p[7])]
    for i, (cin, cout) in zip((4, 5, 6, 7), ups):
        conv(f"convtr{i}p{2**(8-i)}s2", 8, cin, cout)
        bn(f"bntr{i}", cout)
    block_in = [d0, p[0], p[1], p[2], p[4] + p[2], p[5] + p[1], p[6] + p[0], p[7] + d0]
    for bi in range(1, 9):
        cin, planes = block_in[bi - 1], p[bi - 1]
        conv(f"block{bi}.0.conv1", 81, cin, planes)
        conv(f"block{bi}.0.conv2", 81, planes, planes)
        bn(f"block{bi}.0.norm1", planes)
        bn(f"block{bi}.0.norm2", planes)
        if cin != planes:
            sd[f"{prefix}block{bi}.0.downsample.0.kernel"] = rng.normal(
                size=(cin, planes)).astype(np.float32)
            bn(f"block{bi}.0.downsample.1", planes)
    sd[f"{prefix}final.kernel"] = rng.normal(size=(p[7], out_channels)).astype(np.float32)
    sd[f"{prefix}final.bias"] = rng.normal(size=(out_channels,)).astype(np.float32)
    return sd


@pytest.mark.parametrize("prefix,model", [("model.MinkUNet.", "mos4d"),
                                          ("mos.MinkUNet.", "mapmos")])
def test_me_prefixes_match_sps_tpu(prefix, model):
    assert prefix in tconv.ME_PREFIXES
    out = 3 if model == "mos4d" else 1
    sd = _me_state_dict(np.random.default_rng(out), prefix, out)
    got = tconv.state_dict_from_me({k: torch.as_tensor(v) for k, v in sd.items()})
    want = tconv.state_dict_from_jax(jconv.variables_from_state_dict(sd, strip_prefix=prefix))
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    cfg = (tm4.MOS4DConfig(n_scans=10) if model == "mos4d" else tmm.MapMOSConfig())
    net = tm4.MOS4DNet(cfg) if model == "mos4d" else tmm.MapMOSNet(cfg)
    net.load_state_dict(got, strict=True)
    assert got["MinkUNet.final.kernel"].shape == (1, 1, 8, out)
