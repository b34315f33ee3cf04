"""The port's submap join against sps_tpu's (sps_tpu/ops/radius.py), bit
for bit: radius_join_dense's mask and dropped count, and compact_mask's
indices, validity and overflow, on seeded clouds. sps_tpu runs op by op
(no jit). The hash join is not ported and raises."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sps_torch import config as tcfg
from sps_torch import pipeline
from sps_torch.ops import radius as trad
from sps_tpu.ops import radius as jrad

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXTENT = (40, 40, 16)
R = 0.25


def _cloud(seed, n_scan=600, n_query=3000, far=0, invalid=0.1):
    """A scan around the origin, `far` of its points 20 m away (outside the
    window), a tenth invalid; queries over a larger box."""
    rng = np.random.default_rng(seed)
    scan = rng.uniform(-3.0, 3.0, (n_scan, 3)).astype(np.float32)
    scan[:far] += np.float32(20.0)
    sv = rng.random(n_scan) >= invalid
    q = rng.uniform(-5.0, 5.0, (n_query, 3)).astype(np.float32)
    qv = rng.random(n_query) >= 0.05
    return scan, sv, q, qv


CASES = {
    "dense": dict(seed=0),
    "out_of_window": dict(seed=1, far=50),
    "all_invalid": dict(seed=2, invalid=1.1),  # an empty scan
    "few_points": dict(seed=3, n_scan=5),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_radius_join_dense_bit_equal(case):
    scan, sv, q, qv = _cloud(**CASES[case])
    want_m, want_d = jrad.radius_join_dense(jnp.asarray(scan), jnp.asarray(sv), jnp.asarray(q),
                                            jnp.asarray(qv), R, extent=EXTENT)
    got_m, got_d = trad.radius_join_dense(torch.from_numpy(scan), torch.from_numpy(sv),
                                          torch.from_numpy(q), torch.from_numpy(qv), R,
                                          extent=EXTENT)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    assert int(got_d) == int(want_d)
    if case == "out_of_window":
        assert int(got_d) > 0
    if case == "all_invalid":
        assert not got_m.any()
    elif case == "dense":
        assert 0 < int(got_m.sum()) < len(q)


@pytest.mark.parametrize("capacity", [1, 100, 1000, 5000])
def test_compact_mask_bit_equal(capacity):
    """Capacities below the mask's count overflow (extras dropped, counted)."""
    mask = np.random.default_rng(capacity).random(4000) < 0.3
    want = jrad.compact_mask(jnp.asarray(mask), capacity)
    got = trad.compact_mask(torch.from_numpy(mask), capacity)
    for g, w in zip(got, want):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (int(got[2]) > 0) == (capacity < mask.sum())


def test_hash_join_raises():
    with pytest.raises(NotImplementedError, match="item 7"):
        trad.radius_join()
    cfg = tcfg.load(os.path.join(_ROOT, "config", "config_small.yaml"))
    cfg = dataclasses.replace(cfg, tpu=dataclasses.replace(cfg.tpu, join_mode="hash"))
    z = torch.zeros((1, 8, 3))
    with pytest.raises(NotImplementedError, match="JOIN_MODE hash"):
        pipeline.assemble_batch(z, z[..., 0], z[..., 0] > 0, z[0], cfg)
