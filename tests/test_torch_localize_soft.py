"""run_localization with the "sps-soft" filter against sps_tpu's (CPU).

The network is tests/test_torch_stream.py's narrowed atlas form with seeded
weights and topology reuse off (one filter program for sps_tpu to compile;
tests/test_torch_stream.py holds the reuse program), on three scans of test_torch_localize.py's dense world under the
cv prior: scans 0 and 1 weight the points at the prior and refine with
weights, scan 2 registers unfiltered first and then with weights at that
estimate (cv raw-first), and the weight guard runs on each. Seed 4's
scores lie near 0.2 (mean weight 0.6); seed 0's lie near 0.94, a mean
weight of 0.01 that the guard would replace on every scan, leaving the
weights untested. Poses within 1e-3 m and ATE within 1e-3 m, as the other
filters; the kept fraction, here the mean weight (1 - score)^2, within
1e-3 (scores agree to rtol 1e-3 / atol 1e-4, tests/test_torch_stream.py).
The ATE of random weights says nothing of the filter and is not checked.
sps_tpu's run is pinned by scripts/export_torch_assets.py --only
localize_soft (sps_torch/assets/localize_soft_pin.npz;
tests/test_torch_localize.py runs sps_tpu's run_localization live)."""

import dataclasses

import numpy as np
import pytest
from test_torch_localize import DENSE, check_run
from test_torch_stream import _load, digest, pinned

import sps_torch.config as tcfg_mod
from sps_torch.data import synthetic as tsyn
from sps_torch.models import spsnet as tsps
from sps_torch.stream import localize as tloc

SOFT = dict(DENSE, scans_per_seq=3)
KW = dict(prior="cv", init_noise=0.05, seed=1)
RESULT = ("ate_rmse", "kept_frac_mean", "filter", "n_scans", "prior", "epsilon", "init_noise",
          "refine", "icp_iters", "seed", "cv_raw_first")


def config(mod, root):
    """tests/test_torch_stream.py's configuration on the world at `root`,
    topology reuse off."""
    c = _load(mod)
    return dataclasses.replace(c, data=dataclasses.replace(c.data, root=root),
                               tpu=dataclasses.replace(c.tpu, topo_every=0))


def pin_record(sd):
    """What localize_soft_pin.npz records of its run's inputs."""
    return {"world": SOFT, "topo_every": 0, "kw": KW, "weights": digest(sd)}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("soft"))
    tsyn.generate_dense(out, **SOFT)
    return out


def test_sps_soft_matches_sps_tpu(root):
    tcfg = config(tcfg_mod, root)
    sd = tsps.init_state_dict(tcfg.sps_config(1), seed=4)
    got = tloc.run_localization(tcfg, sd, "20220629", "sps-soft", log=lambda _m: None,
                                device="cpu", **KW)
    pin = pinned("localize_soft_pin.npz", "sps-soft", pin_record(sd))
    want, poses = {k: pin[f"result/{k}"].item() for k in RESULT}, pin["poses"]
    check_run(got, want, poses, SOFT["scans_per_seq"], kept_tol=1e-3)
    assert got["cv_raw_first"]
    assert got["kept_frac_mean"] < 0.99  # the weights registered, not the guard's fallback
    assert np.isfinite(got["poses"]).all()
