"""The port's LTS transformer (sps_torch/models/lts.py) against sps_tpu's
SPCTReg (CPU, f32, eval mode).

  * Seeded weights (the port's init_state_dict, carried to flax by
    transposing the Dense kernels) on a small (2, 256, 3) input: scores
    within atol 2e-5 (the same f32 network, sums in another order).
  * The round-5 checkpoint (sps_torch/assets/baselines_r5_lts.npz, which
    the JAX side reads unflattened, as sps_tpu's variables) on the fullest
    window of 20220629's first movers scan, whose scores
    loc_baselines_pin.npz holds: the port within atol 2e-5 of sps_tpu on
    the same input, and within atol 1e-4 of the pin (sps_tpu on its own
    range image of the scan, which the port rebuilds bit for bit,
    tests/test_torch_range_image.py; the movers generator writes scan 0
    alike whatever the scan count). The scores lie in [0, 1].
  * The state_dict loader: 65 leaves, every Dense transposed, strict.
One JAX program a shape: two compiles of a small network."""

import os

import jax
import numpy as np
import torch

from sps_torch import config, convert
from sps_torch.data import blt, synthetic
from sps_torch.data import range_image as ri
from sps_torch.models import lts as tlts
from sps_tpu.models import lts as jlts

ASSETS = convert.ASSETS
CFG = os.path.join(os.path.dirname(os.path.dirname(ASSETS)), "config", "config_loc_movers_v2.yaml")
NPZ = os.path.join(ASSETS, "baselines_r5_lts.npz")
PIN = os.path.join(ASSETS, "loc_baselines_pin.npz")
ATOL = 2e-5


def flax_variables(sd: dict) -> dict:
    """SPCTReg state_dict -> sps_tpu's {"params", "batch_stats"} tree."""
    tree = {"params": {}, "batch_stats": {}}
    for name, v in sd.items():
        *path, leaf = name.split(".")
        node = tree["batch_stats" if leaf in ("mean", "var") else "params"]
        for p in path:
            node = node.setdefault(p, {})
        if leaf == "weight":
            node["kernel"] = v.numpy().T
        else:
            node[leaf] = v.numpy()
    return tree


def _port(sd, x):
    model = tlts.SPCTReg()
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        return model.eval()(torch.as_tensor(x)).numpy()


def _jax(variables, x):
    return np.asarray(jax.jit(jlts.SPCTReg().apply)(variables, x))


def test_seeded_scores_match_sps_tpu():
    sd = tlts.init_state_dict(seed=3)
    x = np.random.default_rng(0).normal(size=(2, 256, 3)).astype(np.float32) * [8, 8, 1]
    x = x.astype(np.float32)
    x[1, :40] = 0  # empty image pixels
    got, want = _port(sd, x), _jax(flax_variables(sd), x)
    assert got.shape == want.shape == (2, 256)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert got.std() > 0.005  # the scores vary with the points


def test_r5_checkpoint_loads_and_matches_sps_tpu_and_the_pin(tmp_path):
    sd = convert.load_baseline_npz(NPZ, "lts")
    assert len(sd) == 65
    n = sum(v.numel() for k, v in sd.items() if not k.endswith((".mean", ".var")))
    assert n == 4498817
    tree = convert.npz_tree(NPZ)
    # Dense kernels are transposed into nn.Linear weights.
    np.testing.assert_array_equal(sd["sa1.qk.weight"].numpy(),
                                  tree["params"]["sa1"]["qk"]["kernel"].T)
    assert "sa1.qk.bias" not in sd and "sa1.v.bias" in sd
    # The pin's scan: 20220629's first movers scan, cut to SCAN_POINTS.
    synthetic.generate_dense(str(tmp_path), **dict(synthetic.MOVERS, scans_per_seq=1))
    scans, _ = blt.load_sequences_raw(str(tmp_path), ["20220629"])
    ns = config.load(CFG).tpu.scan_points
    wins, _ = ri.windows(ri.project(scans[0][:ns]))
    w = int(np.argmax((np.abs(wins).sum(-1) > 0).sum(-1)))  # the fullest window
    x = wins[w:w + 1]
    got = _port(sd, x)
    want = _jax(tree, x)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    with np.load(PIN) as z:
        pin = z["first_scan/lts/scores"]
    assert pin.shape == wins.shape[:2]
    np.testing.assert_allclose(got, pin[w:w + 1], rtol=0, atol=1e-4)
    assert ((got >= 0) & (got <= 1)).all() and got.std() > 0.01
