"""The plain reference against the port's CPU path at a small size, in
float32: the filter's scores over a rebuild and the reuse calls after it
(points outside the cached bricks score 0.5 on both sides). The test
imports both; the reference itself imports nothing of the port."""

import os

import numpy as np
import torch

from benchmark import weights, world
from benchmark.reference import filter as rf
from benchmark.reference import minkunet as mk


def _cfg(tiny):
    from sps_torch import config as pconfig

    bench, root = tiny
    return pconfig.load(os.path.join(root, "tiny.json")), bench, root


def test_filter_scores_match_the_port(tiny):
    from sps_torch.convert import state_dict_from_me
    from sps_torch.stream.engine import StreamingFilter

    cfg, _, _ = _cfg(tiny)
    arch = mk.Arch()
    stable, scans, labels, valids = world.make_data(11, 8192, 4, extent=12.0, traj_step=1.0,
                                                    n_rays=600, max_r=10.0)
    mapv = rf.map_sites(torch.from_numpy(stable), cfg.voxel_size)
    pts = [(torch.from_numpy(scans[i]), torch.from_numpy(valids[i])) for i in range(4)]
    first = rf.Scan(*pts[0], cfg.voxel_size, mapv)
    w = weights.calibrated(arch, 11, "cpu", mk.Pyramid(first.sites, arch))
    filt = StreamingFilter(cfg, state_dict_from_me(w), stable, device="cpu")
    cached = rf.bricks_of(*pts[0], cfg.voxel_size, 8)
    misses = 0
    for i in range(4):
        got, keep, stats = filt(scans[i], valids[i], labels[i], np.eye(4, dtype=np.float32))
        sc = rf.Scan(*pts[i], cfg.voxel_size, mapv, cached=None if i == 0 else cached)
        want = rf.scores(w, arch, sc)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=0)
        assert torch.equal(keep, (want <= cfg.threshold) & pts[i][1])
        assert int(stats["topo_miss_points"]) == int(sc.miss.sum())
        assert bool((got[sc.miss] == 0.5).all())
        misses += int(sc.miss.sum())
    assert misses > 0  # 1 m a scan leaves the cached bricks
