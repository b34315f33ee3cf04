"""The slice as a whole: sps_torch's StreamingFilter against sps_tpu's on the
same synthetic world, scans, poses and weights (CPU, f32).

Atlas engine, conv_mode "zband" (L0 folded: the stem and block8 run the
zband kernels' plain versions here), int8 off, bf16 off, topo_every 2 so
that the three scans take the rebuild, reuse and rebuild programs. Widths
are narrowed (init_dim 4) to keep the CPU cost low. Scores at rtol 1e-3 /
atol 1e-4; keep equal away from the threshold; integer stats and topology
misses equal."""

import dataclasses
import os

import jax
import numpy as np
import pytest

import sps_tpu.config as jcfg_mod
import sps_torch.config as tcfg_mod
from sps_tpu.data import blt, synthetic
from sps_tpu.stream.engine import StreamingFilter as JFilter
from sps_torch.models import spsnet as tsps
from sps_torch.stream.engine import StreamingFilter as TFilter

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OVERRIDES = dict(engine="atlas", conv_mode="zband", zband_levels=1, int8=False,
                 bf16=False, topo_every=2)
NARROW = dict(init_dim=4, planes=(4, 8, 8, 8, 8, 8, 8, 4))
INT_STATS = ("n_scan_voxels", "n_submap_voxels", "n_kept", "overflow", "topo_miss_points")


def _narrow(base):
    """The config class of `base`'s package with a narrowed MinkUNet."""

    class Narrow(base):
        def sps_config(self, batch_size=None):
            s = super().sps_config(batch_size)
            return dataclasses.replace(s, unet=dataclasses.replace(s.unet, **NARROW))

    return Narrow


def _load(mod):
    cfg = mod.load(os.path.join(_HERE, "config", "config_small.yaml"))
    cfg = dataclasses.replace(cfg, tpu=dataclasses.replace(cfg.tpu, **OVERRIDES))
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    return _narrow(type(cfg))(**fields)


def _flax_tree(sd):
    """SPSModel state_dict -> flax {"params", "batch_stats"} tree (numpy)."""
    tree = {"params": {}, "batch_stats": {}}
    for name, v in sd.items():
        *path, leaf = name.split(".")
        node = tree["batch_stats" if leaf in ("mean", "var") else "params"]
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v.numpy()
    return tree


def _pad(scan, ns):
    n = min(len(scan), ns)
    sx = np.zeros((ns, 3), np.float32)
    sl = np.zeros((ns,), np.float32)
    sv = np.zeros((ns,), bool)
    sx[:n], sl[:n], sv[:n] = scan[:n, :3], scan[:n, 3], True
    return sx, sv, sl


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("stream"))
    synthetic.generate(root, sequences=("20220629",), scans_per_seq=3, seed=3,
                       extent=10.0, n_rays=400, ground_points=6000, n_stable=10)
    scans, poses = blt.load_sequences_raw(root, ["20220629"])
    mp = blt.load_map(root, "base_map.asc.npy")
    cfg_t, cfg_j = _load(tcfg_mod), _load(jcfg_mod)
    sd = tsps.init_state_dict(cfg_t.sps_config(1), seed=0)
    f_t = TFilter(cfg_t, sd, mp, device="cpu")
    f_j = JFilter(cfg_j, jax.tree.map(np.asarray, _flax_tree(sd)), mp)
    out = []
    for scan, pose in zip(scans, poses):
        args = _pad(scan, cfg_t.tpu.scan_points) + (pose.astype(np.float32),)
        out.append((f_t(*args), f_j(*args), args[1]))
    return cfg_t.threshold, out


@pytest.mark.parametrize("i", [0, 1, 2], ids=["rebuild", "reuse", "rebuild2"])
def test_stream_scan_matches_sps_tpu(runs, i):
    eps, out = runs
    (s_t, k_t, st_t), (s_j, k_j, st_j), valid = out[i]
    assert not bool(st_t["overflow"]) and not bool(st_j["overflow"])
    s_t, s_j = s_t.numpy(), np.asarray(s_j)
    np.testing.assert_allclose(s_t, s_j, rtol=1e-3, atol=1e-4)
    far = np.abs(s_j - eps) > 1e-3
    np.testing.assert_array_equal(k_t.numpy()[far], np.asarray(k_j)[far])
    for name in INT_STATS:
        assert int(st_t[name]) == int(st_j[name]), name
    for name in ("loss", "r2", "dIoU", "f1"):
        np.testing.assert_allclose(float(st_t[name]), float(st_j[name]), rtol=1e-3, atol=1e-4)
    assert (s_t[valid] > 0).all() and (s_t[~valid] == 0).all()


def test_reuse_scan_counts_misses(runs):
    _, out = runs
    (_, _, st_t), _, _ = out[1]
    assert int(st_t["topo_miss_points"]) > 0
    assert int(out[0][0][2]["topo_miss_points"]) == 0

