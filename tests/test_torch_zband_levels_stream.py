"""StreamingFilter with conv_mode "zband" at zband_levels 2 and 3 against
sps_tpu's on tests/test_torch_stream.py's world and configuration
(config_small, the atlas engine, MinkUNet14 narrowed, f32, int8 off): one
rebuild scan each, scores within rtol 1e-3 / atol 1e-4, keep equal away
from epsilon, integer stats equal (tests/test_torch_zband_levels.py holds
SPSModel and the routes). sps_tpu's side is pinned by
scripts/export_torch_assets.py --only zband_levels (sps_torch/assets/
zband_levels_stream_pin.npz; tests/test_torch_stream.py runs sps_tpu's
filter live)."""

import dataclasses

import numpy as np
import pytest
from test_torch_stream import NARROW, OVERRIDES, WORLD, _load, pinned_runs, world_args

import sps_torch.config as tcfg_mod
from sps_torch.models import spsnet as tsps
from sps_torch.stream.engine import StreamingFilter as TFilter

LEVELS = (2, 3)
META = dict(config="config/config_small.yaml", tpu=OVERRIDES, narrow=NARROW,
            world={**WORLD, "scans_per_seq": 1}, weights_seed=0)


def with_levels(cfg, levels):
    """One rebuild scan (TOPO_EVERY 0) at ZBAND_LEVELS `levels`."""
    over = dict(zband_levels=levels, topo_every=0)
    return type(cfg)(**{**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)},
                        "tpu": dataclasses.replace(cfg.tpu, **over)})


def inputs(root, levels):
    """The configuration, map, filter arguments and weights of a run."""
    cfg_t = with_levels(_load(tcfg_mod), levels)
    mp, argss = world_args(root, META["world"], cfg_t.tpu.scan_points)
    return cfg_t, mp, argss, tsps.init_state_dict(cfg_t.sps_config(1), seed=META["weights_seed"])


@pytest.mark.parametrize("levels", LEVELS)
def test_streaming_filter_zband_levels_match_sps_tpu(levels, tmp_path):
    """One rebuild scan (TOPO_EVERY 0); the scores, keep and integer stats."""
    cfg_t, mp, argss, sd = inputs(str(tmp_path), levels)
    s_t, k_t, st_t = TFilter(cfg_t, sd, mp, device="cpu")(*argss[0])
    [(s_j, k_j, st_j)] = pinned_runs("zband_levels_stream_pin.npz", f"levels{levels}",
                                     {**META, "zband_levels": levels}, mp, argss, sd)
    assert not bool(st_t["overflow"]) and not bool(st_j["overflow"])
    s_j = np.asarray(s_j)
    np.testing.assert_allclose(s_t.numpy(), s_j, rtol=1e-3, atol=1e-4)
    far = np.abs(s_j - cfg_t.threshold) > 1e-3
    np.testing.assert_array_equal(k_t.numpy()[far], np.asarray(k_j)[far])
    for name in ("n_scan_voxels", "n_submap_voxels", "n_kept", "overflow"):
        assert int(st_t[name]) == int(st_j[name]), name
