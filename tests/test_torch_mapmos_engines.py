"""MapMOS on the brick and voxelize (gather) engines against sps_tpu's
MapMOS: logits at rtol 1e-3 / atol 1e-4 (f32), as
test_torch_mos_models.py holds the atlas engine (live). sps_tpu's logits
are pinned by scripts/export_torch_assets.py --only mapmos_engines
(sps_torch/assets/mapmos_engines_pin.npz)."""

import numpy as np
import pytest
import torch
from test_torch_mos_models import _seeded
from test_torch_stream import digest, pinned

from sps_torch.data.bench_world import fingerprint
from sps_torch.models import mapmos as tmm
from sps_torch.structs import Capacities as TCaps
from sps_torch.structs import pad_point_batch as tpad

CAPS = dict(points=1024, voxels=(1024, 512, 256, 256, 256), bricks=(256, 128, 64, 64, 64))
ENGINES = ("brick", "voxelize")


def config(engine):
    return dict(voxel_size=0.25, engine=engine, brick_side=4)


def inputs(engine):
    """The port's seeded MapMOS and the points, as pad_point_batch's
    arguments, and their scan indices."""
    mm = _seeded(tmm.MapMOSNet(tmm.MapMOSConfig(caps=TCaps(**CAPS), **config(engine)),
                               torch.Generator().manual_seed(1)), 1)
    rng = np.random.default_rng(6)
    n = 300
    args = (rng.uniform(-3, 3, (n, 3)).astype(np.float32), np.zeros(n, np.int32),
            rng.integers(0, 2, n), np.zeros(n, np.float32), CAPS["points"])
    idx = np.zeros(CAPS["points"], np.float32)
    idx[:n] = np.where(args[2] == 1, 10, rng.integers(0, 9, n))
    return mm, args, idx


def pin_record(engine, mm, args, idx):
    """What mapmos_engines_pin.npz records of a run's inputs."""
    return {"caps": CAPS, "config": config(engine), "weights": digest(mm.state_dict()),
            "points": [fingerprint(np.asarray(a)) for a in args[:4]], "idx": fingerprint(idx)}


@pytest.mark.parametrize("engine", ENGINES)
def test_mapmos_engines_match_sps_tpu(engine):
    mm, args, idx = inputs(engine)
    pin = pinned("mapmos_engines_pin.npz", engine, pin_record(engine, mm, args, idx))
    want = pin["logits"]
    with torch.no_grad():
        got, aux_t = mm(tpad(*args, device="cpu"), torch.as_tensor(idx))
    assert not bool(aux_t["overflow"].any()) and not bool(pin["overflow"].any())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-4)
    assert np.abs(got.numpy()).max() > 0.1
