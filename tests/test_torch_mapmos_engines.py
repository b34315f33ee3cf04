"""MapMOS on the brick and voxelize (gather) engines against sps_tpu's
MapMOS: logits at rtol 1e-3 / atol 1e-4 (f32), as
test_torch_mos_models.py holds the atlas engine."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_mos_models import _seeded
from test_torch_stream import _flax_tree

from sps_torch.models import mapmos as tmm
from sps_torch.structs import Capacities as TCaps
from sps_torch.structs import pad_point_batch as tpad
from sps_tpu.models import mapmos as jmm
from sps_tpu.structs import Capacities as JCaps
from sps_tpu.structs import pad_point_batch as jpad


@pytest.mark.parametrize("engine", ["brick", "voxelize"])
def test_mapmos_engines_match_sps_tpu(engine):
    caps = dict(points=1024, voxels=(1024, 512, 256, 256, 256), bricks=(256, 128, 64, 64, 64))
    cfg = dict(voxel_size=0.25, engine=engine, brick_side=4)
    mm = _seeded(tmm.MapMOSNet(tmm.MapMOSConfig(caps=TCaps(**caps), **cfg),
                               torch.Generator().manual_seed(1)), 1)
    jnm = jmm.MapMOSNet(jmm.MapMOSConfig(caps=JCaps(**caps), **cfg))
    rng = np.random.default_rng(6)
    n = 300
    args = (rng.uniform(-3, 3, (n, 3)).astype(np.float32), np.zeros(n, np.int32),
            rng.integers(0, 2, n), np.zeros(n, np.float32), caps["points"])
    idx = np.zeros(caps["points"], np.float32)
    idx[:n] = np.where(args[2] == 1, 10, rng.integers(0, 9, n))
    want, aux_j = jax.jit(jnm.apply)(jax.tree.map(np.asarray, _flax_tree(mm.state_dict())),
                                     jpad(*args), jnp.asarray(idx))
    with torch.no_grad():
        got, aux_t = mm(tpad(*args, device="cpu"), torch.as_tensor(idx))
    assert not bool(aux_t["overflow"].any()) and not bool(np.asarray(aux_j["overflow"]).any())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-4)
    assert np.abs(got.numpy()).max() > 0.1
