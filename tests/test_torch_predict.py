"""The port's offline predict path against sps_tpu's (CPU):

- pipeline.assemble_batch on a tiny on-disk world, with and without the
  distance feature: the PointBatch and counters equal, the distances within
  1e-5 m (a norm against a sqrt of a sum of squares);
- SPSModel's PointBatch entry equal to its levels entry;
- eval.predict_step and predict_sequence at narrow widths in f32, the
  port's seeded weights on both sides: scores and metrics at rtol 1e-3 /
  atol 1e-4 (the f32 model tolerance);
- BLTDataModule.batches: identical arrays, and the same ValueError;
- the first scan of sps_torch/assets/predict_pin.npz's v2 run (the trained
  v2 checkpoint, config_loc_movers_v2.yaml with the distance feature,
  bf16 on both sides): scores within 0.05 (the chip runs' bf16 bound),
  keep decisions equal farther than 0.05 from the threshold, Loss/R2/dIoU/
  Precision/Recall/F1 within 0.005 (the gate's half point of uIoU; the CPU
  reads 0.0077 and 4.7e-4).
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sps_torch.config as tcfg_mod
import sps_tpu.config as jcfg_mod
from sps_torch import eval as teval
from sps_torch import pipeline as tpipe
from sps_torch import register as treg
from sps_torch.convert import ASSETS, load_npz
from sps_torch.data import blt as tblt
from sps_torch.data import synthetic
from sps_torch.models import spsnet as tsps
from sps_tpu import eval as jeval
from sps_tpu import pipeline as jpipe
from sps_tpu import register as jreg
from sps_tpu.data import blt as jblt

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_ROOT, "scripts"))
import export_torch_assets as exp  # noqa: E402

SEQ = "20220629"
# A 10 m world: two scans of ~2.8k points, a ~4.3k-point map, ~480 bricks at L0.
WORLD = dict(sequences=(SEQ,), scans_per_seq=2, seed=3, extent=5.0, n_rays=200,
             ground_points=3000, n_stable=6)
TPU = dict(join_mode="dense", join_extent=(160, 160, 64), atlas_extent=(20, 20, 8),
           bricks=(1024, 512, 512, 256, 256), scan_points=4096, submap_points=4096)
TOL = dict(rtol=1e-3, atol=1e-4)


def _cfg(mod, root):
    cfg = exp.loop_config(mod)
    return dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, root=root, test=(SEQ,)),
                               tpu=dataclasses.replace(cfg.tpu, **TPU))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("predict"))
    synthetic.generate(root, **WORLD)
    tcfg, jcfg = _cfg(tcfg_mod, root), _cfg(jcfg_mod, root)
    sd = tsps.init_state_dict(tcfg.sps_config(1), seed=exp.LOOP_SEED)
    variables = jax.tree.map(jnp.asarray, exp.flax_tree(sd))
    return root, tcfg, jcfg, sd, variables


def test_blt_batches_identical(world):
    _, tcfg, jcfg, _, _ = world
    tdm, jdm = tblt.BLTDataModule(tcfg, test=True), jblt.BLTDataModule(jcfg, test=True)
    np.testing.assert_array_equal(tdm.map_points, jdm.map_points)
    assert len(tdm.test) == len(jdm.test) == WORLD["scans_per_seq"]
    for a, b in zip(tdm.test.scans, jdm.test.scans):
        np.testing.assert_array_equal(a, b)
    for bs, shuffle in ((2, True), (1, False)):
        got = list(tdm.batches(tdm.test, bs, shuffle=shuffle, seed=5))
        want = list(jdm.batches(jdm.test, bs, shuffle=shuffle, seed=5))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in g:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    small = dataclasses.replace(tcfg, tpu=dataclasses.replace(tcfg.tpu, scan_points=100))
    with pytest.raises(ValueError, match="SCAN_POINTS"):
        next(tblt.BLTDataModule(small, test=True).batches(tdm.test, 1, shuffle=False))


@pytest.mark.parametrize("dist", [False, True], ids=["plain", "map_vm"])
def test_assemble_batch_matches(world, dist):
    _, tcfg, jcfg, _, _ = world
    dm = tblt.BLTDataModule(tcfg, test=True)
    b = next(dm.batches(dm.test, 2, shuffle=False))
    mp = dm.map_points
    tvm = treg.build_voxel_map(mp, 0.4, device="cpu") if dist else None
    jvm = jreg.build_voxel_map(mp, voxel_size=0.4) if dist else None
    got, gaux = tpipe.assemble_batch(torch.from_numpy(b["xyz"]), torch.from_numpy(b["label"]),
                                     torch.from_numpy(b["valid"]), torch.from_numpy(mp), tcfg,
                                     map_vm=tvm)
    want, waux = jpipe.assemble_batch(jnp.asarray(b["xyz"]), jnp.asarray(b["label"]),
                                      jnp.asarray(b["valid"]), jnp.asarray(mp), jcfg,
                                      map_vm=jvm)
    for f in ("xyz", "batch", "t", "label", "valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    for k in waux:
        assert int(gaux[k]) == int(waux[k]), k
    assert int(gaux["submap_count"]) > 0
    if dist:
        np.testing.assert_allclose(got.dist.numpy(), np.asarray(want.dist), rtol=0, atol=1e-5)
        assert float(got.dist.max()) <= 1.0
    else:
        assert got.dist is None and want.dist is None


def test_pointbatch_entry_equals_levels_entry(world):
    _, tcfg, _, sd, _ = world
    dm = tblt.BLTDataModule(tcfg, test=True)
    b = next(dm.batches(dm.test, 1, shuffle=False))
    pb, _ = tpipe.assemble_batch(*(torch.from_numpy(b[k]) for k in ("xyz", "label", "valid")),
                                 torch.from_numpy(dm.map_points), tcfg)
    scfg = tcfg.sps_config(1)
    model = tsps.SPSModel(scfg)
    model.load_state_dict(sd, strict=True)
    model.eval()
    with torch.inference_mode():
        got, aux = model(pb)
        levels, p2s, _ = tsps.build_pyramid(pb, scfg)
        want, _ = model(levels=levels, p2v=p2s, t_idx=pb.t, valid=pb.valid)
    assert torch.equal(got, want)
    assert (got[pb.valid] > 0).all() and aux["overflow"].shape == (5,)


def test_predict_step_and_sequence_match(world, capsys):
    _, tcfg, jcfg, sd, variables = world
    dm = tblt.BLTDataModule(tcfg, test=True)
    mp = dm.map_points
    model = tsps.SPSModel(tcfg.sps_config(1))
    model.load_state_dict(sd, strict=True)
    model.eval()
    for b in dm.batches(dm.test, 1, shuffle=False):
        tb = {k: torch.from_numpy(b[k]) for k in ("xyz", "label", "valid")}
        jb = {k: jnp.asarray(b[k]) for k in ("xyz", "label", "valid")}
        with torch.inference_mode():
            s_t, mask_t, m_t = teval.predict_step(model, tb, torch.from_numpy(mp), cfg=tcfg)
        s_j, mask_j, m_j = jeval.predict_step(variables, jb, jnp.asarray(mp), cfg=jcfg)
        np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
        np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), **TOL)
        for k in teval.METRICS:
            np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), **TOL, err_msg=k)
        assert bool(m_t["overflow"]) == bool(m_j["overflow"])
    got = teval.predict_sequence(tcfg, sd, device="cpu")
    want = jeval.predict_sequence(jcfg, variables)
    for k in teval.METRICS:
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)
    table = capsys.readouterr().out
    assert table.count("Inference Metrics") == 2 and "F1 ........." in table


def test_v2_pin_first_scan(tmp_path):
    """The trained v2 checkpoint under the distance feature, bf16."""
    pin = np.load(os.path.join(ASSETS, "predict_pin.npz"))
    root = str(tmp_path)
    synthetic.generate_dense(root, **dict(synthetic.MOVERS, scans_per_seq=1))
    cfg = tcfg_mod.load(os.path.join(_ROOT, "config", "config_loc_movers_v2.yaml"),
                        data_root=root)
    assert cfg.dist_feature and cfg.threshold == float(pin["v2/threshold"])
    dm = tblt.BLTDataModule(dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, test=(SEQ,))), test=True)
    b = next(dm.batches(dm.test, 1, shuffle=False))
    model = tsps.SPSModel(cfg.sps_config(1))
    model.load_state_dict(load_npz(os.path.join(ASSETS, "ckpt_loc_movers_v2.npz")), strict=True)
    model.eval()
    vm = treg.build_voxel_map(dm.map_points, 4 * cfg.voxel_size, device="cpu")
    with torch.inference_mode():
        s, _, m = teval.predict_step(model, {k: torch.from_numpy(b[k]) for k in
                                             ("xyz", "label", "valid")},
                                     torch.from_numpy(dm.map_points), vm, cfg=cfg)
    ns = cfg.tpu.scan_points
    got, want, v = s.float().numpy()[:ns], pin["v2/scores"][0], pin["v2/valid"][0]
    np.testing.assert_array_equal(b["valid"][0], v)
    assert np.abs(got - want)[v].max() <= 0.05
    far = v & (np.abs(want - cfg.threshold) > 0.05)
    np.testing.assert_array_equal((got >= cfg.threshold)[far], (want >= cfg.threshold)[far])
    for k in teval.METRICS:
        assert abs(float(m[k]) - float(pin[f"v2/{k}"][0])) <= 0.005, k
    assert bool(m["overflow"]) == bool(pin["v2/overflow"][0])
