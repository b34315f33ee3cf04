"""parallel.mesh.dryrun on spawned gloo ranks (sps_tpu's dryrun_multichip):
one training step of the flagship configuration at tiny capacities, then
one sp StreamingFilter scan over all ranks. On 4 ranks the mesh is dp x sp =
2 x 2, on 2 ranks dp 2; both see the same two samples, so the loss (the dp
mean of the per-sample losses) agrees within 1e-6, every rank of a run
returns the same loss and the same digest of its trained state (replicated
parameters and BN statistics), and the filter keeps every valid point of
an untrained model's scan the same way on every rank."""

import numpy as np
import pytest

from sps_torch.parallel import launch
from sps_torch.parallel import mesh as pm


def dryrun_rank(rank, world):
    return pm.dryrun(world, device="cpu")


@pytest.fixture(scope="module")
def runs():
    return {n: launch.spawn(dryrun_rank, n, timeout=300.0) for n in (4, 2)}


@pytest.mark.parametrize("world,axes", [(4, {"dp": 2, "sp": 2}), (2, {"dp": 2})])
def test_dryrun_ranks_agree(runs, world, axes):
    res = runs[world]
    assert all(r["axes"] == axes for r in res)
    assert np.isfinite(res[0]["loss"])
    assert len({r["loss"] for r in res}) == 1
    assert len({r["digest"] for r in res}) == 1
    assert len({r["kept"] for r in res}) == 1 and res[0]["kept"] > 0


def test_dp_sp_loss_equals_dp_loss(runs):
    np.testing.assert_allclose(runs[4][0]["loss"], runs[2][0]["loss"], rtol=1e-6)
