"""The exported round-5 checkpoint and pins (scripts/export_torch_assets.py).

sps_torch/assets/ckpt_loc_movers_v2.npz equals the orbax checkpoint
ckpt_loc_movers_v2/best leaf for leaf and loads (strict) into the port's
SPSModel for config/config_loc_movers_v2.yaml; its config sidecar is the
checkpoint's. The port's scores of the movers dataset's first scan (bf16,
as the configuration ships) against sps_tpu's pinned ones: max |dscore|
within 0.05, the bound the chip runs hold bf16 to against f32, and keep
decisions at epsilon 0.99 equal for points farther than 0.05 from it."""

import json
import os

import numpy as np

from sps_torch import config as tcfg_mod
from sps_torch.convert import ASSETS, load_npz
from sps_torch.data import blt, synthetic
from sps_torch.models import spsnet as tsps
from sps_torch.stream.engine import StreamingFilter
from sps_tpu.utils import checkpoint as ckpt

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(ASSETS, "ckpt_loc_movers_v2.npz")
PIN = os.path.join(ASSETS, "loc_movers_v2_pin.npz")
CFG = os.path.join(_ROOT, "config", "config_loc_movers_v2.yaml")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict) else {name: np.asarray(v)})
    return out


def test_npz_equals_the_orbax_checkpoint():
    r = ckpt.restore(os.path.join(_ROOT, "ckpt_loc_movers_v2", "best"))
    want = _flat({"params": r["params"], "batch_stats": r["batch_stats"]})
    with np.load(NPZ) as z:
        assert sorted(z.files) == sorted(want)
        for k in z.files:
            assert z[k].dtype == np.float32, k
            np.testing.assert_array_equal(z[k], want[k], err_msg=k)
    n = sum(v.size for k, v in want.items() if k.startswith("params/"))
    assert n == 1_847_977
    with open(os.path.join(ASSETS, "ckpt_loc_movers_v2.config.json")) as f:
        sidecar = json.load(f)
    assert sidecar == r["config"]
    assert sidecar["dist_feature"] and not sidecar["tpu"]["int8"]


def _cfg():
    """config_loc_movers_v2.yaml at the checkpoint's ATE-calibrated epsilon."""
    import dataclasses

    with open(os.path.join(_ROOT, "ckpt_loc_movers_v2", "calibration.json")) as f:
        eps = json.load(f)["epsilon_ate"]
    return dataclasses.replace(tcfg_mod.load(CFG), threshold=eps)


def test_npz_loads_into_the_port_for_the_v2_config():
    cfg = _cfg()
    scfg = cfg.sps_config(1)
    assert scfg.dist_feature and scfg.unet.in_channels == 2 and scfg.unet.conv_mode == "halo"
    assert not scfg.unet.int8 and not scfg.unet.head_fold and cfg.tpu.topo_every == 0
    sd = load_npz(NPZ)
    model = tsps.SPSModel(scfg)
    model.load_state_dict(sd, strict=True)
    k = np.load(NPZ)["params/MinkUNet/conv0p1s1/kernel"]
    np.testing.assert_array_equal(model.MinkUNet.conv0p1s1.kernel.detach().numpy(), k)
    assert k.shape[-2] == 2


def test_first_scan_scores_match_the_pin(tmp_path):
    pin = np.load(PIN)
    assert float(pin["epsilon"]) == _cfg().threshold == 0.99
    root = str(tmp_path)
    synthetic.generate_dense(root, **dict(synthetic.MOVERS, scans_per_seq=1))
    cfg = _cfg()
    scans, gt = blt.load_sequences_raw(root, ["20220629"])
    filt = StreamingFilter(cfg, load_npz(NPZ), blt.load_map(root, cfg.data.map_file),
                           device="cpu")
    ns = cfg.tpu.scan_points
    n = min(len(scans[0]), ns)
    sx = np.zeros((ns, 3), np.float32)
    sl = np.zeros(ns, np.float32)
    sv = np.zeros(ns, bool)
    sx[:n], sl[:n], sv[:n] = scans[0][:n, :3], scans[0][:n, 3], True
    np.testing.assert_array_equal(sv, pin["first_scan/valid"])
    scores, _, stats = filt(sx, sv, sl, gt[0].astype(np.float32))
    got, want = scores.float().numpy(), pin["first_scan/scores"]
    # The configuration's window does not hold the whole scan, in sps_tpu too.
    for k in ("overflow", "n_scan_voxels", "n_submap_voxels"):
        assert int(stats[k]) == int(pin[f"first_scan/{k}"]), k
    assert np.abs(got - want).max() <= 0.05
    eps = cfg.threshold
    far = sv & (np.abs(want - eps) > 0.05)
    np.testing.assert_array_equal((got <= eps)[far], (want <= eps)[far])
    # The trained filter separates the labels: clutter scores high.
    assert got[sv & (sl > 0.5)].mean() > got[sv & (sl < 0.5)].mean() + 0.3
