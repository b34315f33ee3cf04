"""The port's SPSModel in halo mode against sps_tpu's (CPU, f32).

conv_mode "halo" runs every brick conv, the 5^3 stem included, as a dense
conv over the assembled halo. Two configurations: int8 and head_fold off,
and both on (the shipping options), on tests/test_torch_model.py's points
and narrow widths, with seeded weights and random BN statistics carried
to sps_tpu's tree. sps_tpu's scores are pinned by
scripts/export_torch_assets.py --only halo (sps_torch/assets/halo_pin.npz;
tests/test_torch_model.py runs sps_tpu's SPSModel live).

Tolerances. With int8 off: rtol 1e-3 / atol 1e-4 (the same network, sums
taken in another order). With int8 on, the codes are round(x / s_in) of
activations that the two frameworks compute in another summation order,
so a code can move by one where x / s_in lies at a rounding tie, and all
codes can move where s_in = max|x| / 127 moves by an ulp. One code step
is 1/127 of a layer's max-abs; carried to a logit of O(1) and through the
sigmoid (slope <= 1/4), one step moves a score by at most
7.9e-3 / 4 ~ 2e-3 = INT8_ATOL. The int8 runs hold every score within
INT8_ATOL, keep decisions equal for the points whose reference score lies
farther than 1e-2 from the threshold, and the number kept equal up to the
points whose reference score lies within INT8_ATOL of it.
"""

import dataclasses

import numpy as np
import pytest
import torch
from test_torch_model import CAPS, TCFG, _points
from test_torch_stream import model_record, pinned

from sps_torch.models import spsnet as tsps
from sps_torch.structs import pad_point_batch as tpad

INT8_ATOL = 2e-3
OPTIONS = {"plain": dict(int8=False, head_fold=False), "int8-head_fold": dict(int8=True,
                                                                                head_fold=True)}


def check_int8_scores(got, want, valid, eps):
    """The int8 runs' tolerance (module docstring)."""
    assert np.abs(got - want).max() <= INT8_ATOL
    far = valid & (np.abs(want - eps) > 1e-2)
    np.testing.assert_array_equal((got <= eps)[far], (want <= eps)[far])
    near = valid & (np.abs(want - eps) <= INT8_ATOL)
    assert abs(int(((got <= eps) & valid).sum()) - int(((want <= eps) & valid).sum())) <= near.sum()


def halo(cfg, opts):
    """`cfg` (either package's SPSConfig) in conv_mode halo with OPTIONS[opts]."""
    return dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet, conv_mode="halo",
                                                             **OPTIONS[opts]))


def inputs():
    """Seeded weights with random BN statistics (the port's init_state_dict)
    and the points."""
    return tsps.init_state_dict(TCFG, seed=0), _points(3)


@pytest.fixture(scope="module")
def weights():
    return inputs()[0]


@pytest.mark.parametrize("opts", sorted(OPTIONS))
def test_spsmodel_halo_matches_sps_tpu(weights, opts):
    tcfg = halo(TCFG, opts)
    pts = _points(3)
    sd = weights
    pin = pinned("halo_pin.npz", opts, model_record(tcfg, sd, (*pts, CAPS["points"])))
    want = pin["scores"]
    assert not bool(pin["overflow"].any())

    model = tsps.SPSModel(tcfg)
    model.load_state_dict(sd, strict=True)
    model.eval()
    pb_t = tpad(*pts, CAPS["points"], device="cpu")
    with torch.inference_mode():
        levels, p2s, _ = tsps.build_pyramid(pb_t, tcfg)
        got, _ = model(levels=levels, p2v=p2s, t_idx=pb_t.t, valid=pb_t.valid)
    got, valid = got.numpy(), pb_t.valid.numpy()
    if OPTIONS[opts]["int8"]:
        check_int8_scores(got, want, valid, tcfg.threshold)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    assert (got[~valid] == 0).all() and (got[valid] > 0).all()
