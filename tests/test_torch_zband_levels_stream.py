"""StreamingFilter with conv_mode "zband" at zband_levels 2 and 3 against
sps_tpu's on tests/test_torch_stream.py's world and configuration
(config_small, the atlas engine, MinkUNet14 narrowed, f32, int8 off): one
rebuild scan each, scores within rtol 1e-3 / atol 1e-4, keep equal away
from epsilon, integer stats equal (tests/test_torch_zband_levels.py holds
SPSModel and the routes)."""

import dataclasses

import jax
import numpy as np
import pytest
from test_torch_stream import _flax_tree, _load, _pad

import sps_tpu.config as jcfg_mod
import sps_torch.config as tcfg_mod
from sps_tpu.data import blt, synthetic
from sps_tpu.stream.engine import StreamingFilter as JFilter
from sps_torch.models import spsnet as tsps
from sps_torch.stream.engine import StreamingFilter as TFilter

LEVELS = (2, 3)


@pytest.mark.parametrize("levels", LEVELS)
def test_streaming_filter_zband_levels_match_sps_tpu(levels, tmp_path):
    """One rebuild scan (TOPO_EVERY 0); the scores, keep and integer stats."""
    root = str(tmp_path)
    synthetic.generate(root, sequences=("20220629",), scans_per_seq=1, seed=3, extent=10.0,
                       n_rays=400, ground_points=6000, n_stable=10)
    scans, poses = blt.load_sequences_raw(root, ["20220629"])
    mp = blt.load_map(root, "base_map.asc.npy")
    over = dict(zband_levels=levels, topo_every=0)
    cfg_t, cfg_j = _load(tcfg_mod), _load(jcfg_mod)
    cfg_t = type(cfg_t)(**{**{f.name: getattr(cfg_t, f.name) for f in dataclasses.fields(cfg_t)},
                           "tpu": dataclasses.replace(cfg_t.tpu, **over)})
    cfg_j = type(cfg_j)(**{**{f.name: getattr(cfg_j, f.name) for f in dataclasses.fields(cfg_j)},
                           "tpu": dataclasses.replace(cfg_j.tpu, **over)})
    sd = tsps.init_state_dict(cfg_t.sps_config(1), seed=0)
    args = _pad(scans[0], cfg_t.tpu.scan_points) + (poses[0].astype(np.float32),)
    s_t, k_t, st_t = TFilter(cfg_t, sd, mp, device="cpu")(*args)
    s_j, k_j, st_j = JFilter(cfg_j, jax.tree.map(np.asarray, _flax_tree(sd)), mp)(*args)
    assert not bool(st_t["overflow"]) and not bool(st_j["overflow"])
    s_j = np.asarray(s_j)
    np.testing.assert_allclose(s_t.numpy(), s_j, rtol=1e-3, atol=1e-4)
    far = np.abs(s_j - cfg_t.threshold) > 1e-3
    np.testing.assert_array_equal(k_t.numpy()[far], np.asarray(k_j)[far])
    for name in ("n_scan_voxels", "n_submap_voxels", "n_kept", "overflow"):
        assert int(st_t[name]) == int(st_j[name]), name


