"""run_localization with the baseline filters on the CPU against sps_tpu's
pin (sps_torch/assets/loc_baselines_pin.npz, scripts/export_torch_assets.py
--only loc_baselines: sps_tpu's run_localization on the movers data,
config_loc_movers_v2.yaml at epsilon 0.99, prior odom, init_noise 0.05,
refine, seed 0, the round-5 baseline checkpoints, one cache across runs).

Each case localizes the first scans of 20220629 with the round-5 weights
(sps_torch/assets/baselines_r5_*.npz) and holds each scan's pose against
the pin's: the movers generator writes a sequence's first scans (and the
map) alike whatever the scan count, and a run is causal, so the first k
poses of a k-scan run are the pin's first k. The cases share one cache
(the registration maps of the one map), as the pin's runs did. A
baseline scan costs two filter calls and two registrations (~3 s each on
the CPU); a full-size MapMOS call takes ~5 s and a MOS4D call ~14 s, so
MapMOS runs one scan, mask and LTS two, and MOS4D, one scan, is in
tests/test_torch_localize_mos4d.py (each file under 60 s).
Translations within 1e-3 m (as test_torch_localize.py), rotations within
1e-3."""

import dataclasses
import json
import os

import numpy as np
import pytest

from sps_torch import config
from sps_torch.convert import ASSETS
from sps_torch.data import synthetic
from sps_torch.stream import localize as tloc

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(_ROOT, "config", "config_loc_movers_v2.yaml")
PIN = os.path.join(ASSETS, "loc_baselines_pin.npz")
SCANS = {"mask": 2, "lts": 2, "mapmos": 1, "mos4d": 1}


@pytest.fixture(scope="module")
def cache():
    return {}


def movers_config(root, k):
    """The movers data with k scans a sequence under `root`, and
    config_loc_movers_v2.yaml on it at the pin's epsilon."""
    synthetic.generate_dense(root, **dict(synthetic.MOVERS, scans_per_seq=k))
    return dataclasses.replace(config.load(CFG, data_root=root),
                               threshold=float(np.load(PIN)["epsilon"]))


def localize_against_pin(mode, cfg, cache):
    """The first SCANS[mode] scans of 20220629 under the pin's protocol,
    held against the pin's poses. Returns run_localization's result."""
    k = SCANS[mode]
    r = tloc.run_localization(cfg, None, "20220629", mode, prior="odom", init_noise=0.05,
                              refine=True, seed=0, baseline_weights=ASSETS, cache=cache,
                              log=lambda _m: None, device="cpu")
    want = np.load(PIN)[f"20220629/{mode}/poses"][:k]
    assert r["poses"].shape == want.shape == (k, 4, 4)
    np.testing.assert_allclose(r["poses"][:, :3, 3], want[:, :3, 3], rtol=0, atol=1e-3)
    np.testing.assert_allclose(r["poses"][:, :3, :3], want[:, :3, :3], rtol=0, atol=1e-3)
    assert r["filter"] == mode and r["n_scans"] == k and not r["cv_raw_first"]
    return r


@pytest.mark.parametrize("mode", ["mask", "mapmos", "lts"])
def test_baseline_localization_matches_the_pin(mode, tmp_path, cache):
    cfg = movers_config(str(tmp_path), SCANS[mode])
    calls = []
    if mode == "mapmos":
        # Record each call's logits: its decisions must be the pin's (f32 on
        # both sides) except within 1e-4 of 0.
        filt = tloc._make_baseline_filter(cfg, "mapmos", synthetic_map(cfg), ASSETS, "cpu")

        class Recording(type(filt)):
            def push(self, scan_xyz, pose):
                lg = super().push(scan_xyz, pose)
                calls.append(lg.numpy().copy())
                return lg

        filt.__class__ = Recording
        cache["mapmos"] = filt
    r = localize_against_pin(mode, cfg, cache)
    # LTS registers its resampled kept points, all of which count as kept;
    # the other filters drop points.
    if mode == "lts":
        assert (r["kept_frac"] == 1).all()
    else:
        assert (r["kept_frac"] < 1).all() and (r["kept_frac"] > tloc.GUARD_FLOOR).all()
    if mode == "mapmos":
        pin = np.load(PIN)
        assert len(calls) == 2 * SCANS[mode]
        for i, lg in enumerate(calls):
            assert len(lg) == pin["20220629/mapmos/call_n"][i]
            want = np.unpackbits(pin["20220629/mapmos/call_keeps"][i])[:len(lg)].astype(bool)
            assert not ((lg <= 0) != want)[np.abs(lg) > 1e-4].any()


def synthetic_map(cfg):
    from sps_torch.data import blt

    return blt.load_map(cfg.data.root, cfg.data.map_file)


def test_cli_localizes_with_a_baseline(tmp_path, capsys):
    """python -m sps_torch.stream.localize --filter ... --baseline-weights DIR:
    a log line a scan, then the result as JSON."""
    root = str(tmp_path)
    synthetic.generate_dense(root, **dict(synthetic.MOVERS, scans_per_seq=1))
    tloc.main(["-c", CFG, "-seq", "20220629", "--data", root, "--filter", "mask",
               "--init-noise", "0.05", "--baseline-weights", ASSETS, "--device", "cpu"])
    text = capsys.readouterr().out
    assert text.startswith("[mask] scan 0:")
    out = json.loads(text[text.index("\n{") + 1:])
    assert out["filter"] == "mask" and out["n_scans"] == 1 and out["init_noise"] == 0.05
    assert len(out["poses"]) == 1 and out["ate_rmse"] < 0.1
