"""run_localization with the MOS4D baseline on the CPU against sps_tpu's
pin, in a file of its own (a full-size MOS4D call, 4 x 12,288 points at
T = 4 in bf16, takes ~14 s on the CPU, and a scan makes two).

MOS4D computes in bf16 on both sides, and the registration of its kept
points is chaotic in the keep mask: on 20220629's first scan, 5 of 5,014
decisions that differ within the bf16 band move the first registration by
13 cm, while the port's ICP on sps_tpu's keep mask lands within 0.01 mm of
sps_tpu's pose. So the run is pinned to sps_tpu's trajectory
(chip_smoke.pinned, as chip_smoke.py phase 11): each call runs the port's
MOS4D at the pin's pose (its buffer holds what sps_tpu's held), its
decisions must equal the pin's outside 2^-4 of the call's largest |logit|
(and differ on at most 1% of the points), the pose the driver gave it must
be the pin's within 1e-3 m, and the pin's keep mask goes on to the
registration, whose poses are held within 1e-3 m
(test_torch_localize_baselines.py)."""

import os
import sys

import numpy as np
from test_torch_localize_baselines import (ASSETS, PIN, localize_against_pin, movers_config,
                                           synthetic_map)

from sps_torch.stream import localize as tloc

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402


def test_mos4d_pinned_localization_matches_the_pin(tmp_path):
    cfg = movers_config(str(tmp_path), 1)
    pin = np.load(PIN)
    key = "20220629/mos4d"
    filt = chip_smoke.pinned(
        tloc._make_baseline_filter(cfg, "mos4d", synthetic_map(cfg), ASSETS, "cpu"),
        (pin[key + "/call_poses"], pin[key + "/call_n"], pin[key + "/call_keeps"]))
    r = localize_against_pin("mos4d", cfg, {"mos4d": filt})
    assert len(filt.record) == 2  # the filter at the prior, then the refine
    for call in filt.record:
        assert call["flips_outside_band"] == 0 and call["pose_gap_m"] < 1e-3
        assert call["flips"] <= 0.01 * call["n"]
    assert (r["kept_frac"] < 1).all() and (r["kept_frac"] > tloc.GUARD_FLOOR).all()
    # The rerun replaced the newest buffered scan: one scan in the buffer.
    assert len(filt.buffer) == 1
