"""The port's submap join against sps_tpu's (sps_tpu/ops/radius.py), bit
for bit: radius_join_dense's and radius_join's (the hash join) masks and
dropped counts, and compact_mask's indices, validity and overflow, on
seeded clouds; assemble_batch under JOIN_MODE hash against sps_tpu's.
sps_tpu runs op by op (no jit), its hash join and assemble_batch under
jit."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sps_torch import config as tcfg
from sps_torch import pipeline
from sps_torch.ops import radius as trad
from sps_tpu import config as jcfg
from sps_tpu import pipeline as jpipeline
from sps_tpu.ops import radius as jrad

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXTENT = (40, 40, 16)
R = 0.25


def _cloud(seed, n_scan=600, n_query=3000, far=0, invalid=0.1, cluster=0):
    """A scan around the origin, `far` of its points 20 m away (outside the
    window), `cluster` of them in one cell (more than a candidate list
    holds), a tenth invalid; queries over a larger box."""
    rng = np.random.default_rng(seed)
    scan = rng.uniform(-3.0, 3.0, (n_scan, 3)).astype(np.float32)
    scan[:far] += np.float32(20.0)
    scan[far:far + cluster] = rng.uniform(0.01, 0.24, (cluster, 3)).astype(np.float32)
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
HASH_CASES = {**CASES, "full_cell": dict(seed=4, cluster=30)}


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


@pytest.mark.parametrize("case", sorted(HASH_CASES))
def test_radius_join_hash_bit_equal(case):
    """The hash join (JOIN_MODE hash): the exact Euclidean join through the
    scan's cell table; a cell with more points than its list drops the
    later ones in scan order (the stable sort), counted in `dropped`."""
    scan, sv, q, qv = _cloud(**HASH_CASES[case])
    kw = dict(cell_capacity=2048, max_per_cell=8)
    want_m, want_d = jax.jit(lambda a, b, c, d: jrad.radius_join(a, b, c, d, R, **kw))(
        jnp.asarray(scan), jnp.asarray(sv), jnp.asarray(q), jnp.asarray(qv))
    got_m, got_d = trad.radius_join(torch.from_numpy(scan), torch.from_numpy(sv),
                                    torch.from_numpy(q), torch.from_numpy(qv), R, **kw)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    assert int(got_d) == int(want_d) and got_d.dtype == torch.int32
    if case == "full_cell":
        assert int(got_d) > 0
    if case == "all_invalid":
        assert not got_m.any()
    elif case == "dense":
        assert 0 < int(got_m.sum()) < len(q)


def test_assemble_batch_hash_join_matches_sps_tpu():
    """config_small.yaml as shipped (JOIN_MODE hash): the PointBatch and the
    counters equal sps_tpu's for a batch of two scans."""
    path = os.path.join(_ROOT, "config", "config_small.yaml")
    cfg_t, cfg_j = tcfg.load(path), jcfg.load(path)
    cfg_t = dataclasses.replace(cfg_t, tpu=dataclasses.replace(cfg_t.tpu, submap_points=1024))
    cfg_j = dataclasses.replace(cfg_j, tpu=dataclasses.replace(cfg_j.tpu, submap_points=1024))
    assert cfg_t.tpu.join_mode == "hash"
    scans, labels, valids = [], [], []
    for seed in (5, 6):
        scan, sv, _, _ = _cloud(seed)
        # 12 points in one cell of edge VOXEL_SIZE (0.1): more than its list.
        scan[:12] = np.random.default_rng(seed).uniform(0.01, 0.09, (12, 3))
        sv[:12] = True
        scans.append(scan)
        valids.append(sv)
        labels.append(np.random.default_rng(seed).random(len(scan)).astype(np.float32))
    scans, labels, valids = np.stack(scans), np.stack(labels), np.stack(valids)
    mp = np.random.default_rng(7).uniform(-4.0, 4.0, (6000, 3)).astype(np.float32)
    pb_j, aux_j = jax.jit(lambda a, b, c, d: jpipeline.assemble_batch(a, b, c, d, cfg_j))(
        *map(jnp.asarray, (scans, labels, valids, mp)))
    pb_t, aux_t = pipeline.assemble_batch(*map(torch.from_numpy, (scans, labels, valids, mp)),
                                          cfg_t)
    for name in ("xyz", "batch", "t", "label", "valid"):
        np.testing.assert_array_equal(getattr(pb_t, name).numpy(),
                                      np.asarray(getattr(pb_j, name)), err_msg=name)
    for name in ("submap_overflow", "cell_dropped", "submap_count"):
        assert int(aux_t[name]) == int(aux_j[name]), name
    assert int(aux_t["cell_dropped"]) > 0 and int(aux_t["submap_count"]) > 0
