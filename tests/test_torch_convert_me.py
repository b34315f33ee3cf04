"""The port's reference-checkpoint loader (sps_torch.convert.load_me_ckpt)
against sps_tpu's (convert.torch_ckpt_to_variables, then the port's
state_dict_from_jax) on tests/fixtures/me_golden.ckpt, a Lightning file in
the reference's MinkowskiEngine layout: equal leaf for leaf, every tensor
consumed, loaded strictly. Then the scores of the loaded weights on a narrow
atlas configuration (brick side 8, ROW_FROM 3, halo convs, f32) against
sps_tpu's atlas engine from the same checkpoint: rtol 1e-3 / atol 1e-4,
the port's f32 model tolerance (the same network, sums in another order)."""

import os

import jax
import numpy as np
import pytest
import torch

from sps_torch import convert as tconv
from sps_torch.models import spsnet as tsps
from sps_torch.models.minkunet import MinkUNetConfig as TUNetConfig
from sps_torch.structs import Capacities as TCaps
from sps_torch.structs import pad_point_batch as tpad
from sps_tpu import convert as jconv
from sps_tpu.models.minkunet import MinkUNetConfig as JUNetConfig
from sps_tpu.models.spsnet import SPSConfig as JSPSConfig
from sps_tpu.models.spsnet import SPSModel as JSPSModel
from sps_tpu.structs import Capacities as JCaps
from sps_tpu.structs import pad_point_batch as jpad

CKPT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "me_golden.ckpt")
# The fixture's widths (scripts/make_torch_golden.py).
NARROW = dict(in_channels=1, out_channels=1, init_dim=4, planes=(4, 8, 8, 8, 8, 8, 8, 4),
              num_time=2, conv_mode="halo")
CAPS = dict(points=2048, voxels=(1024, 512, 512, 256, 128), bricks=(128, 64, 64, 64, 64))
ATLAS = dict(voxel_size=0.25, engine="atlas", brick_side=8, atlas_extent=(2, 6, 6, 6),
             row_from=3)
JCFG = JSPSConfig(caps=JCaps(**CAPS), unet=JUNetConfig(**NARROW), **ATLAS)
TCFG = tsps.SPSConfig(caps=TCaps(**CAPS), unet=TUNetConfig(**NARROW), **ATLAS)


@pytest.fixture(scope="module")
def jax_variables():
    return jax.tree.map(np.asarray, jconv.torch_ckpt_to_variables(CKPT, JCFG))


def test_load_me_ckpt_equals_sps_tpu_leaf_for_leaf(jax_variables):
    got = tconv.load_me_ckpt(CKPT, TCFG)
    want = tconv.state_dict_from_jax(jax_variables)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32 and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k
    # A 3^3 x 3 block kernel went through the 4-D split, the stem through the
    # spatial permutation: neither is ME's order unchanged.
    raw = torch.load(CKPT, map_location="cpu", weights_only=True)["state_dict"]
    stem = raw["model.MinkUNet.conv0p1s1.kernel"]
    assert not torch.equal(got["MinkUNet.conv0p1s1.kernel"][:, 0], stem)


def test_every_tensor_consumed_and_loads_strictly():
    raw = torch.load(CKPT, map_location="cpu", weights_only=True)["state_dict"]
    want = sorted(v.numel() for k, v in raw.items() if "num_batches_tracked" not in k)
    sd = tconv.load_me_ckpt(CKPT, TCFG)
    assert sorted(v.numel() for v in sd.values()) == want
    tsps.SPSModel(TCFG).load_state_dict(sd, strict=True)
    # An extra tensor is not silently dropped.
    with pytest.raises(ValueError, match="not consumed"):
        tconv.state_dict_from_me({**raw, "model.MinkUNet.extra.kernel": torch.zeros(3)})
    # load_weights picks the loader by suffix.
    assert tconv.load_weights(CKPT, TCFG).keys() == sd.keys()


def _points(seed, n=500):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-3, 3, size=(n, 3)).astype(np.float32)
    return (xyz, rng.integers(0, 2, size=n), rng.integers(0, 2, size=n),
            rng.uniform(0, 1, size=n).astype(np.float32))


def test_scores_match_sps_tpu_atlas_engine(jax_variables):
    pts = _points(11)
    want, aux_j = jax.jit(lambda v, b: JSPSModel(JCFG).apply(v, b))(
        jax_variables, jpad(*pts, CAPS["points"]))
    assert not bool(np.asarray(aux_j["overflow"]).any())
    model = tsps.SPSModel(TCFG)
    model.load_state_dict(tconv.load_me_ckpt(CKPT, TCFG), strict=True)
    model.eval()
    with torch.inference_mode():
        got, aux_t = model(tpad(*pts, CAPS["points"], device="cpu"))
    assert not bool(aux_t["overflow"].any())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-4)
