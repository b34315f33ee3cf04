"""The slice as a whole in the shipping configuration: sps_torch's
StreamingFilter against sps_tpu's on the same synthetic world, scans,
poses and weights (CPU, f32).

The options of config/config.yaml's TPU section (atlas engine, CONV_MODE
halo, INT8, HEAD_FOLD) on config_small.yaml, with bf16 off and
topo_every 2, so that the three scans take the rebuild, reuse and rebuild
programs. Cut to run on the CPU: narrow widths (init_dim 4), a 12 m world
(extent 6) and brick capacities (1024, 512, 256, 256, 256), which hold
its ~700 / 170 / 40 bricks at L0 / L1 / L2. The scores hold the int8
tolerance of tests/test_torch_halo.py; integer stats other than n_kept and
the topology misses are equal. sps_tpu's side is pinned by
scripts/export_torch_assets.py --only shipping (sps_torch/assets/
shipping_pin.npz; tests/test_torch_stream.py runs sps_tpu's filter live).
"""

import dataclasses

import numpy as np
import pytest
from test_torch_halo import check_int8_scores
from test_torch_stream import INT_STATS, NARROW, _narrow, pinned_runs, world_args

import sps_torch.config as tcfg_mod
from sps_torch.models import spsnet as tsps
from sps_torch.stream.engine import StreamingFilter as TFilter

SHIPPING = dict(engine="atlas", conv_mode="halo", int8=True, head_fold=True, bf16=False,
                topo_every=2, bricks=(2048, 1024, 512, 512, 512))
WORLD = dict(sequences=("20220629",), scans_per_seq=3, seed=3, extent=6.0, n_rays=400,
             ground_points=4000, n_stable=8)
META = dict(config="config/config_small.yaml", tpu=SHIPPING, narrow=NARROW, world=WORLD,
            weights_seed=0)


def _load(mod):
    """config_small.yaml with the shipping TPU options, narrowed."""
    cfg = mod.load("config/config_small.yaml")
    cfg = dataclasses.replace(cfg, tpu=dataclasses.replace(cfg.tpu, **SHIPPING))
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    return _narrow(type(cfg))(**fields)


def inputs(root):
    """The configuration, map, filter arguments and weights of the runs."""
    cfg_t = _load(tcfg_mod)
    mp, argss = world_args(root, WORLD, cfg_t.tpu.scan_points)
    return cfg_t, mp, argss, tsps.init_state_dict(cfg_t.sps_config(1), seed=META["weights_seed"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg_t, mp, argss, sd = inputs(str(tmp_path_factory.mktemp("stream")))
    unet = cfg_t.sps_config(1).unet
    assert unet.conv_mode == "halo" and unet.int8 and unet.head_fold
    f_t = TFilter(cfg_t, sd, mp, device="cpu")
    want = pinned_runs("shipping_pin.npz", "shipping", META, mp, argss, sd)
    return cfg_t.threshold, [(f_t(*args), w, args[1]) for args, w in zip(argss, want)]


@pytest.mark.parametrize("i", [0, 1, 2], ids=["rebuild", "reuse", "rebuild2"])
def test_stream_shipping_matches_sps_tpu(runs, i):
    eps, out = runs
    (s_t, k_t, st_t), (s_j, k_j, st_j), valid = out[i]
    assert not bool(st_t["overflow"]) and not bool(st_j["overflow"])
    s_t, s_j = s_t.numpy(), np.asarray(s_j)
    check_int8_scores(s_t, s_j, valid, eps)
    np.testing.assert_array_equal(k_t.numpy(), (s_t <= eps) & valid)
    for name in INT_STATS:
        if name != "n_kept":  # held by check_int8_scores
            assert int(st_t[name]) == int(st_j[name]), name
    assert int(st_t["n_kept"]) == int(k_t.sum())
    assert (s_t[valid] > 0).all() and (s_t[~valid] == 0).all()
    if i == 1:
        assert int(st_t["topo_miss_points"]) > 0
