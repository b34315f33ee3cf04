"""The distance feature (SPSConfig.dist_feature) with STEM_ZBAND against
sps_tpu (CPU): the stem's two input channels fold into the C = 48 z-band
stem that the wgmma_k5_wide kernel runs on the card.

SPSModel at tests/test_torch_dist.py's small configuration (halo mode, two
input channels, tests/test_torch_model.py's capacities and narrow widths)
with stem_zband on, the same numpy-seeded points, distances and weights in
both frameworks: scores at test_torch_dist.py's rtol 1e-3 / atol 1e-4 (f32;
the same network, sums in another order). Then the port's folded stem
against its halo stem on the same weights in bf16, within
tests/test_minkunet.py::test_stem_zband_matches_halo_stem's atol 1e-2."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_torch_dist import _dist_cfg, _dists
from test_torch_model import CAPS, JCFG, TCFG, _points
from test_torch_stream import _flax_tree

from sps_tpu.models.spsnet import SPSModel as JSPSModel
from sps_tpu.structs import pad_point_batch as jpad
from sps_torch.models import spsnet as tsps
from sps_torch.ops import zband_conv as zc
from sps_torch.structs import pad_point_batch as tpad


def _stem_cfg(cfg, stem_zband=True, **unet):
    cfg = _dist_cfg(cfg)
    return dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet, stem_zband=stem_zband,
                                                             **unet))


def _inputs(seed=3):
    pts = _points(seed)
    pdist = np.zeros(CAPS["points"], np.float32)
    pdist[: len(pts[0])] = _dists(len(pts[0]), seed + 1)
    return pts, pdist


def _port_scores(cfg, sd, pts, pdist):
    model = tsps.SPSModel(cfg)
    model.load_state_dict(sd, strict=True)
    model.eval()
    pb = tpad(*pts, CAPS["points"], device="cpu")
    with torch.inference_mode():
        levels, p2s, _ = tsps.build_pyramid(pb, cfg)
        got, _ = model(levels=levels, p2v=p2s, t_idx=pb.t, valid=pb.valid,
                       point_dist=torch.from_numpy(pdist))
    return got.float().numpy(), pb.valid.numpy()


def test_spsmodel_dist_stem_zband_matches_sps_tpu(monkeypatch):
    tcfg, jcfg = _stem_cfg(TCFG), _stem_cfg(JCFG)
    assert tcfg.unet.in_channels == 2 and tcfg.unet.stem_zband and tcfg.dist_feature
    sd = tsps.init_state_dict(tcfg, seed=2)
    pts, pdist = _inputs()
    variables = jax.tree.map(np.asarray, _flax_tree(sd))
    want, aux = jax.jit(lambda v, b, d: JSPSModel(jcfg).apply(v, b, point_dist=d))(
        variables, jpad(*pts, CAPS["points"]), jnp.asarray(pdist))
    want = np.asarray(want)
    assert not bool(np.asarray(aux["overflow"]).any())
    # The port's forward takes the folded stem: one z-band conv of the C = 48
    # halo, the shape the card routes to wgmma_k5_wide in bf16.
    calls = []
    ref = zc.zband_conv_ref

    def counted(hz, wz, k, bs):
        calls.append((tuple(hz.shape), tuple(wz.shape), k, bs))
        return ref(hz, wz, k, bs)

    monkeypatch.setattr(zc, "zband_conv_ref", counted)
    got, valid = _port_scores(tcfg, sd, pts, pdist)
    assert calls == [((CAPS["bricks"][0], 12, 12, 48), (5, 5, 48, 8 * 4 * 2), 5, 8)]
    hz, wz = torch.zeros(calls[0][0], dtype=torch.bfloat16), torch.zeros(calls[0][1],
                                                                          dtype=torch.bfloat16)
    # At the test's narrow width N = 64, the card runs it on wmma; at the
    # full init_dim 8 (N = 128) on wgmma_k5_wide.
    assert zc.route(hz, wz, 5, 8) == "wmma"
    wide = torch.zeros((5, 5, 48, 128), dtype=torch.bfloat16)
    assert zc.route(hz, wide, 5, 8) == "wgmma_k5_wide"
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    assert (got[~valid] == 0).all() and (got[valid] > 0).all()


def test_dist_stem_zband_matches_halo_stem():
    """bf16, the port alone: STEM_ZBAND's folded stem against the halo stem
    on the same weights and inputs, with the distance feature on."""
    zcfg = _stem_cfg(TCFG, dtype=torch.bfloat16)
    hcfg = _stem_cfg(TCFG, stem_zband=False, dtype=torch.bfloat16)
    sd = tsps.init_state_dict(zcfg, seed=5)
    pts, pdist = _inputs(7)
    got, valid = _port_scores(zcfg, sd, pts, pdist)
    want, _ = _port_scores(hcfg, sd, pts, pdist)
    np.testing.assert_allclose(got, want, atol=1e-2)
    assert (got[valid] > 0).all() and (got[~valid] == 0).all()
    base, _ = _port_scores(zcfg, sd, pts, np.zeros_like(pdist))
    assert np.abs(got - base).max() > 1e-3  # the distances reach the scores
