"""The trained v1 checkpoint and the int8 parity gate
(tests/test_int8_parity.py) on the port, against sps_tpu's pins
(scripts/export_torch_assets.py).

- sps_torch/assets/ckpt_loc_movers.npz equals the orbax checkpoint
  ckpt_loc_movers/best leaf for leaf and loads strictly for
  config_loc_movers.yaml, int8 and head fold on or off.
- The gate's first scan (20220608 generated alone, epsilon 0.9, bf16), the
  float run and the INT8 + HEAD_FOLD run, against int8_parity_pin.npz:
  scores within 0.05 (the bf16 bound) at all but 0.2% of the valid points,
  none beyond 0.25; keep decisions (score > eps) equal for the points whose
  pinned score lies farther than 0.05 from eps; the scan's uIoU within
  0.005 of the pin's. The points beyond 0.05 are the neighbourhood of one
  map voxel that sps_tpu, under jit, quantizes one voxel away
  (test_xla_quantizes_by_the_reciprocal). The six-scan uIoU bound does not
  fit here: the int8 plain version (an f64 conv on the CPU) takes ~30 s a
  scan, so chip_smoke.py phase 9a runs the whole gate on the card.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sps_torch.config as tcfg_mod
from sps_torch.convert import ASSETS, load_npz
from sps_torch.data import blt, synthetic
from sps_torch.models import spsnet as tsps
from sps_torch.ops import voxelize as tvox
from sps_torch.stream.engine import StreamingFilter
from sps_tpu.ops import voxelize as jvox
from sps_tpu.utils import checkpoint as ckpt

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(ASSETS, "ckpt_loc_movers.npz")
PIN = os.path.join(ASSETS, "int8_parity_pin.npz")
CFG = os.path.join(_ROOT, "config", "config_loc_movers.yaml")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict) else {name: np.asarray(v)})
    return out


def test_v1_npz_equals_the_orbax_checkpoint():
    r = ckpt.restore(os.path.join(_ROOT, "ckpt_loc_movers", "best"))
    want = _flat({"params": r["params"], "batch_stats": r["batch_stats"]})
    with np.load(NPZ) as z:
        assert sorted(z.files) == sorted(want)
        for k in z.files:
            assert z[k].dtype == np.float32, k
            np.testing.assert_array_equal(z[k], want[k], err_msg=k)
    assert sum(v.size for k, v in want.items() if k.startswith("params/")) == 1_846_977
    with open(os.path.join(ASSETS, "ckpt_loc_movers.config.json")) as f:
        assert json.load(f) == r["config"]


@pytest.mark.parametrize("opts", [{}, dict(int8=True, head_fold=True)], ids=["float", "int8"])
def test_v1_loads_for_the_movers_config(opts):
    cfg = tcfg_mod.load(CFG)
    cfg = dataclasses.replace(cfg, tpu=dataclasses.replace(cfg.tpu, **opts))
    scfg = cfg.sps_config(1)
    assert not scfg.dist_feature and scfg.unet.in_channels == 1
    model = tsps.SPSModel(scfg)
    model.load_state_dict(load_npz(NPZ), strict=True)
    assert model.MinkUNet.conv0p1s1.kernel.shape[-2] == 1


@pytest.fixture(scope="module")
def gate(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("parity"))
    synthetic.generate_dense(root, **synthetic.PARITY)
    pin = dict(np.load(PIN))
    cfg = dataclasses.replace(tcfg_mod.load(CFG, data_root=root),
                              threshold=float(pin["epsilon"]))
    scans, poses = blt.load_sequences_raw(root, list(synthetic.PARITY["sequences"]))
    return cfg, scans, poses, blt.load_map(root, cfg.data.map_file), pin


def _uiou(s, lab, eps):
    pred, true = s > eps, lab > eps
    return (pred & true).sum() / max((pred & true).sum() + (pred ^ true).sum(), 1)


@pytest.mark.limit(600)  # 155 s on a worker of -n 6 (8 CPUs)
@pytest.mark.parametrize("run", ["float", "int8_head_fold"])
def test_gate_first_scan_matches_the_pin(gate, run):
    cfg, scans, poses, mp, pin = gate
    assert len(scans) == int(pin["scans"]) == 6 and cfg.threshold == 0.9
    opts = dict(int8=True, head_fold=True) if run != "float" else {}
    cfg = dataclasses.replace(cfg, tpu=dataclasses.replace(cfg.tpu, **opts))
    filt = StreamingFilter(cfg, load_npz(NPZ), mp, device="cpu")
    ns = cfg.tpu.scan_points
    n = min(len(scans[0]), ns)
    sx = np.zeros((ns, 3), np.float32)
    sl = np.zeros(ns, np.float32)
    sv = np.zeros(ns, bool)
    sx[:n], sl[:n], sv[:n] = scans[0][:n, :3], scans[0][:n, 3], True
    np.testing.assert_array_equal(sv, pin["valid"][0])
    scores, _, _ = filt(sx, sv, sl, poses[0].astype(np.float32))
    got, want = scores.float().numpy()[sv], pin[f"{run}/scores"][0][sv]
    gap = np.abs(got - want)
    assert (gap > 0.05).mean() <= 0.002 and gap.max() <= 0.25, (gap > 0.05).sum()
    eps = cfg.threshold
    far = np.abs(want - eps) > 0.05
    np.testing.assert_array_equal((got > eps)[far], (want > eps)[far])
    assert abs(_uiou(got, sl[sv], eps) - _uiou(want, sl[sv], eps)) <= 0.005


def test_xla_quantizes_by_the_reciprocal(gate):
    """Under jit XLA turns sps_tpu's `points / voxel_size` into a multiply by
    1 / voxel_size: points within an ulp of a voxel face land one voxel
    over. The port divides, as sps_tpu's source and its eager run do."""
    mp = gate[3]
    port = tvox.quantize(torch.from_numpy(mp), 0.1).numpy()
    eager = np.asarray(jvox.quantize(jnp.asarray(mp), 0.1))
    jitted = np.asarray(jax.jit(lambda p: jvox.quantize(p, 0.1))(jnp.asarray(mp)))
    np.testing.assert_array_equal(port, eager)
    moved = (jitted != eager).any(-1)
    assert 0 < moved.sum() <= 10
    faces = mp[moved] / np.float32(0.1)
    assert (np.abs(faces - np.round(faces)) < 1e-4).any(-1).all()
