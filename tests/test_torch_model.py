"""Port of SPSModel (atlas engine, conv_mode "zband", L0 folded) against
sps_tpu's SPSModel on the same points and the same weights, carried across
by sps_torch.convert.state_dict_from_jax. Narrow widths as in
tests/test_minkunet.py; f32; scores at rtol 1e-3 / atol 1e-4 (the same
network, with sums taken in another order)."""

import dataclasses

import flax
import jax
import numpy as np
import pytest
import torch

from sps_tpu.models.minkunet import MinkUNetConfig as JUNetConfig
from sps_tpu.models.spsnet import SPSConfig as JSPSConfig
from sps_tpu.models.spsnet import SPSModel as JSPSModel
from sps_tpu.structs import Capacities as JCaps
from sps_tpu.structs import pad_point_batch as jpad
from sps_tpu.utils import geometry as jgeo
from sps_tpu.utils import metrics as jmet
from sps_torch.convert import state_dict_from_jax
from sps_torch.models import spsnet as tsps
from sps_torch.models.minkunet import MinkUNetConfig as TUNetConfig
from sps_torch.structs import Capacities as TCaps
from sps_torch.structs import pad_point_batch as tpad
from sps_torch.utils import geometry as tgeo
from sps_torch.utils import metrics as tmet

T = 2
NARROW = dict(in_channels=1, out_channels=1, init_dim=4,
              planes=(4, 8, 8, 8, 8, 8, 8, 4), num_time=T)
CAPS = dict(points=2048, voxels=(1024, 512, 512, 256, 128), bricks=(128, 64, 64, 64, 64))
ATLAS = dict(voxel_size=0.25, engine="atlas", brick_side=8, atlas_extent=(2, 6, 6, 6),
             row_from=3)

JCFG = JSPSConfig(caps=JCaps(**CAPS), unet=JUNetConfig(**NARROW, conv_mode="zband",
                                                       zband_levels=1), **ATLAS)
TCFG = tsps.SPSConfig(caps=TCaps(**CAPS), unet=TUNetConfig(**NARROW, conv_mode="zband",
                                                           zband_levels=1), **ATLAS)


_japply = jax.jit(lambda v, b: JSPSModel(JCFG).apply(v, b))


def _points(seed, n=500):
    """tests/test_minkunet.py's _batch: two scans in a 6 m cube, both time slots."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-3, 3, size=(n, 3)).astype(np.float32)
    batch = rng.integers(0, 2, size=n)
    t = rng.integers(0, T, size=n)
    label = rng.uniform(0, 1, size=n).astype(np.float32)
    return xyz, batch, t, label


@pytest.fixture(scope="module")
def weights():
    pb = jpad(*_points(0), CAPS["points"])
    variables = jax.jit(JSPSModel(JCFG).init)(jax.random.PRNGKey(0), pb)
    # Random running statistics, so that eval-mode BN is not the identity.
    rng = np.random.default_rng(1)
    flat = flax.traverse_util.flatten_dict(variables["batch_stats"])
    stats = {
        k: (0.3 * rng.standard_normal(v.shape) if k[-1] == "mean"
            else 0.5 + rng.random(v.shape)).astype(np.float32)
        for k, v in flat.items()
    }
    variables = dict(variables, batch_stats=flax.traverse_util.unflatten_dict(stats))
    return jax.tree.map(np.asarray, variables)


def test_state_dict_from_jax_consumes_every_tensor(weights):
    sd = state_dict_from_jax(weights)
    leaves = jax.tree.leaves(weights)
    assert sorted(np.asarray(v).size for v in leaves) == sorted(v.numel() for v in sd.values())
    model = tsps.SPSModel(TCFG)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    k = weights["params"]["MinkUNet"]["block8_0"]["conv1"]["kernel"]
    np.testing.assert_array_equal(model.MinkUNet.block8_0.conv1.kernel.detach().numpy(), k)


@pytest.mark.parametrize("seed", [3, 29])
def test_spsmodel_zband_matches_sps_tpu(weights, seed):
    pts = _points(seed)
    pb_j = jpad(*pts, CAPS["points"])
    want, aux_j = _japply(weights, pb_j)
    assert not bool(np.asarray(aux_j["overflow"]).any())

    model = tsps.SPSModel(TCFG)
    model.load_state_dict(state_dict_from_jax(weights), strict=True)
    model.eval()
    pb_t = tpad(*pts, CAPS["points"], device="cpu")
    with torch.inference_mode():
        levels, p2s, overflow = tsps.build_pyramid(pb_t, TCFG)
        got, aux_t = model(levels=levels, p2v=p2s, t_idx=pb_t.t, valid=pb_t.valid)
    assert not bool(aux_t["overflow"].any()) and not bool(overflow.any())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-4)
    valid = pb_t.valid.numpy()
    assert (got.numpy()[~valid] == 0).all() and (got.numpy()[valid] > 0).all()


def test_unported_options_raise(weights):
    """Of sps_tpu's options, every one runs in the port (the name is kept
    from when conv_mode "region" raised): int8 and head_fold run, and
    stem_zband (the k = 5 stem alone folded) and conv_mode "region" (a SAME
    conv within each brick plus one small conv per neighbour region) score
    as the halo configuration does on the same weights
    (tests/test_minkunet.py::test_stem_zband_matches_halo_stem's bar, atol
    1e-2; f32 here, so the sums differ in order only: 1e-5)."""
    pb_t = tpad(*_points(3), CAPS["points"], device="cpu")
    halo = dataclasses.replace(TCFG, unet=dataclasses.replace(TCFG.unet, conv_mode="halo"))
    sd = state_dict_from_jax(weights)
    for opts, like_halo in ((dict(stem_zband=True, conv_mode="halo"), True),
                            (dict(conv_mode="region"), True),
                            (dict(int8=True, head_fold=True, conv_mode="halo"), False)):
        cfg = dataclasses.replace(TCFG, unet=dataclasses.replace(TCFG.unet, **opts))
        model = tsps.SPSModel(cfg)
        levels, p2s, _ = tsps.build_pyramid(pb_t, cfg)
        if like_halo:
            ref = tsps.SPSModel(halo)
            for m in (model, ref):
                m.load_state_dict(sd, strict=True)
                m.eval()
            with torch.inference_mode():
                got, _ = model(levels=levels, p2v=p2s, t_idx=pb_t.t, valid=pb_t.valid)
                want, _ = ref(levels=levels, p2v=p2s, t_idx=pb_t.t, valid=pb_t.valid)
            valid = pb_t.valid.numpy()
            assert bool((got.numpy()[valid] > 0).all())
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
        else:
            scores, _ = model(levels=levels, p2v=p2s, t_idx=pb_t.t, valid=pb_t.valid)
            assert bool(torch.isfinite(scores).all())


def test_geometry_and_metrics_match():
    rng = np.random.default_rng(4)
    pts = rng.uniform(-20, 20, (300, 3)).astype(np.float32)
    a = rng.uniform(-np.pi, np.pi)
    tr = np.eye(4, dtype=np.float32)
    tr[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    tr[:3, 3] = rng.uniform(-5, 5, 3)
    np.testing.assert_allclose(
        tgeo.transform_points(torch.from_numpy(pts), torch.from_numpy(tr)).numpy(),
        np.asarray(jgeo.transform_points(pts, tr)), rtol=1e-5, atol=1e-5)
    scores = rng.random(300).astype(np.float32)
    labels = (rng.random(300) < 0.3).astype(np.float32)
    mask = rng.random(300) < 0.8
    t = [torch.from_numpy(x) for x in (scores, labels, mask)]
    got = {"mse": tmet.masked_mse(*t), "r2": tmet.masked_r2(*t),
           **tmet.classification_metrics(*t, 0.84)}
    want = {"mse": jmet.masked_mse(scores, labels, mask),
            "r2": jmet.masked_r2(scores, labels, mask),
            **jmet.classification_metrics(scores, labels, mask, 0.84)}
    for key, v in want.items():
        np.testing.assert_allclose(float(got[key]), float(v), rtol=1e-5, atol=1e-6, err_msg=key)
