"""conv_mode "zband" with zband_levels 2 and 3: brick levels L0..L1 or
L0..L2 run z-folded, every BasicBlock conv there fused on the zband_conv
kernels' plain versions (here on the CPU), the 1x1 downsample as the
block-diagonal kron on the folded layout, the down / up convs folding their
outputs. Against sps_tpu on the same weights and inputs (atlas, side 8,
row_from 3, f32, MinkUNet14 narrowed as in tests/test_torch_model.py; sps_tpu
runs its zband_conv_fused CPU branch): SPSModel's scores within rtol 1e-3 /
atol 1e-4 (StreamingFilter's in tests/test_torch_zband_levels_stream.py). Also: the fused calls a forward (2 / 6 / 10 at zband_levels 1 /
2 / 3) and zband_conv.route at the seven L1 / L2 shapes of MinkUNet14 at
full width (bf16), each "wgmma"."""

import jax
import numpy as np
import pytest
import torch
from test_torch_model import ATLAS, CAPS, NARROW, T, _points
from test_torch_stream import _flax_tree

from sps_tpu.models.minkunet import MinkUNetConfig as JUNetConfig
from sps_tpu.models.spsnet import SPSConfig as JSPSConfig
from sps_tpu.models.spsnet import SPSModel as JSPSModel
from sps_tpu.structs import Capacities as JCaps
from sps_tpu.structs import pad_point_batch as jpad
from sps_torch.models import spsnet as tsps
from sps_torch.models.minkunet import MinkUNetConfig as TUNetConfig
from sps_torch.ops import zband_conv as zc
from sps_torch.structs import Capacities as TCaps
from sps_torch.structs import pad_point_batch as tpad

LEVELS = (2, 3)
FUSED = {1: 2, 2: 6, 3: 10}
# (call, B at config.yaml, TCin, TCout) of the L1 / L2 BasicBlock convs at
# full width: C = 10 * TCin halo channels, N = 8 * TCout.
NEW_SHAPES = [("block1_0.conv1/conv2", 3072, 16, 16), ("block7_0.conv1", 3072, 48, 32),
              ("block7_0.conv2", 3072, 32, 32), ("block2_0.conv1", 1024, 16, 32),
              ("block2_0.conv2", 1024, 32, 32), ("block6_0.conv1", 1024, 96, 64),
              ("block6_0.conv2", 1024, 64, 64)]


def _cfgs(levels):
    j = JSPSConfig(caps=JCaps(**CAPS), unet=JUNetConfig(**NARROW, conv_mode="zband",
                                                       zband_levels=levels), **ATLAS)
    t = tsps.SPSConfig(caps=TCaps(**CAPS), unet=TUNetConfig(**NARROW, conv_mode="zband",
                                                           zband_levels=levels), **ATLAS)
    return j, t


@pytest.fixture
def fused_calls(monkeypatch):
    calls = []
    real = zc.zband_conv_fused

    def counted(hz, wz, *a, **kw):
        calls.append((tuple(hz.shape), tuple(wz.shape)))
        return real(hz, wz, *a, **kw)

    monkeypatch.setattr(zc, "zband_conv_fused", counted)
    return calls


@pytest.mark.parametrize("levels", LEVELS)
def test_spsmodel_zband_levels_match_sps_tpu(levels, fused_calls):
    jcfg, tcfg = _cfgs(levels)
    sd = tsps.init_state_dict(tcfg, seed=0)
    pts = _points(3)
    want, aux_j = jax.jit(lambda v, b: JSPSModel(jcfg).apply(v, b))(
        jax.tree.map(np.asarray, _flax_tree(sd)), jpad(*pts, CAPS["points"]))
    model = tsps.SPSModel(tcfg)
    model.load_state_dict(sd, strict=True)
    model.eval()
    pb = tpad(*pts, CAPS["points"], device="cpu")
    with torch.inference_mode():
        got, aux_t = model(pb)
    assert not bool(np.asarray(aux_j["overflow"]).any()) and not bool(aux_t["overflow"].any())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-4)
    valid = pb.valid.numpy()
    assert (got.numpy()[valid] > 0).all() and (got.numpy()[~valid] == 0).all()
    assert len(fused_calls) == FUSED[levels]
    # Folded levels: L0 (B 128), then L1 (64), then L2 (64): the brick caps.
    folded = sorted({hz[0] for hz, _ in fused_calls})
    assert folded == sorted(set(CAPS["bricks"][:levels]))


@pytest.mark.parametrize("call,b,tcin,tcout", NEW_SHAPES, ids=[s[0] for s in NEW_SHAPES])
def test_route_takes_the_l1_l2_shapes(call, b, tcin, tcout):
    """The fused call at each new shape routes to the wgmma kernel
    (zband_conv_sm90.cu: bf16, k 3, bs 8, C % 32 == 0, N % 128 == 0)."""
    bs, k = 8, 3
    hz = torch.zeros((2, bs + 2, bs + 2, (bs + 2) * tcin), dtype=torch.bfloat16)
    wz = torch.zeros((k, k, (bs + 2) * tcin, bs * tcout), dtype=torch.bfloat16)
    n = bs * tcout
    scale, bias = torch.zeros(n), torch.zeros(n)
    occ = torch.zeros((2, bs, bs, n), dtype=torch.bfloat16)
    assert zc.route(hz, wz, k, bs, scale, bias, occ, occ) == "wgmma", (call, hz.shape, wz.shape)
    assert b % 128 == 0 and T == 2
