"""The slice as a whole: sps_torch's StreamingFilter against sps_tpu's on the
same synthetic world, scans, poses and weights (CPU, f32).

Atlas engine, conv_mode "zband" (L0 folded: the stem and block8 run the
zband kernels' plain versions here), int8 off, bf16 off, topo_every 2 so
that the three scans take the rebuild, reuse and rebuild programs. Widths
are narrowed (init_dim 4) to keep the CPU cost low. Scores at rtol 1e-3 /
atol 1e-4; keep equal away from the threshold; integer stats and topology
misses equal."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest

import sps_tpu.config as jcfg_mod
import sps_torch.config as tcfg_mod
from sps_tpu.data import blt, synthetic
from sps_tpu.stream.engine import StreamingFilter as JFilter
from sps_torch.convert import ASSETS
from sps_torch.data.bench_world import fingerprint
from sps_torch.models import spsnet as tsps
from sps_torch.stream.engine import StreamingFilter as TFilter

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OVERRIDES = dict(engine="atlas", conv_mode="zband", zband_levels=1, int8=False,
                 bf16=False, topo_every=2)
NARROW = dict(init_dim=4, planes=(4, 8, 8, 8, 8, 8, 8, 4))
INT_STATS = ("n_scan_voxels", "n_submap_voxels", "n_kept", "overflow", "topo_miss_points")
WORLD = dict(sequences=("20220629",), scans_per_seq=3, seed=3, extent=10.0, n_rays=400,
             ground_points=6000, n_stable=10)


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


def world_args(root, world, ns):
    """A synthetic world's map, and its scans as StreamingFilter arguments."""
    synthetic.generate(root, **world)
    scans, poses = blt.load_sequences_raw(root, list(world["sequences"]))
    mp = blt.load_map(root, "base_map.asc.npy")
    return mp, [_pad(scan, ns) + (pose.astype(np.float32),) for scan, pose in zip(scans, poses)]


def digest(sd):
    """A fingerprint of a state dict's values."""
    return fingerprint(np.concatenate([v.numpy().ravel() for v in sd.values()]))


def pinned(name, key, record):
    """The arrays that scripts/export_torch_assets.py pinned under `key` of
    sps_torch/assets/<name>, once the pin's record of its inputs is shown to
    be `record`, this test's own."""
    with np.load(os.path.join(ASSETS, name)) as z:
        assert json.loads(str(z["meta"]))[key] == json.loads(json.dumps(record))
        return {k[len(key) + 1:]: z[k] for k in z.files if k.startswith(key + "/")}


def model_record(cfg, sd, args):
    """What a pin of sps_tpu's SPSModel records of a call's inputs: the port's
    configuration, the weights and pad_point_batch's arguments."""
    return {"config": repr(cfg), "weights": digest(sd),
            "points": [fingerprint(np.asarray(a)) for a in args]}


def pin_record(meta, mp, args, sd):
    """What a pin of sps_tpu's StreamingFilter records of its run's inputs:
    the test's constants (meta) and fingerprints of the map, the scans'
    valid points, their poses and the weights."""
    return {**meta, "map": fingerprint(mp), "scans": [fingerprint(a[0][a[1]]) for a in args],
            "poses": [fingerprint(a[3]) for a in args], "weights": digest(sd)}


def pinned_runs(name, key, meta, mp, args, sd):
    """sps_tpu's StreamingFilter on these inputs, as pinned under `key` of
    sps_torch/assets/<name>: per scan the scores, keep and stats."""
    pin = pinned(name, key, pin_record(meta, mp, args, sd))
    return [(pin[f"{i}/scores"], pin[f"{i}/keep"],
             {k.rsplit("/", 1)[1]: v for k, v in pin.items() if k.startswith(f"{i}/stats/")})
            for i in range(len(args))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg_t, cfg_j = _load(tcfg_mod), _load(jcfg_mod)
    mp, argss = world_args(str(tmp_path_factory.mktemp("stream")), WORLD, cfg_t.tpu.scan_points)
    sd = tsps.init_state_dict(cfg_t.sps_config(1), seed=0)
    f_t = TFilter(cfg_t, sd, mp, device="cpu")
    f_j = JFilter(cfg_j, jax.tree.map(np.asarray, _flax_tree(sd)), mp)
    return cfg_t.threshold, [(f_t(*args), f_j(*args), args[1]) for args in argss]


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

