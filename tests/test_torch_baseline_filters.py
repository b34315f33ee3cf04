"""The port's baseline filters (sps_torch/stream/baselines.py) against
sps_tpu's (CPU).

  * scans_from_ckpt_name: the same buffer lengths.
  * MOS4DFilter: the network replaced on both sides by the same function
    of its inputs, so the test sees what each filter hands its model. Over
    five scans of different sizes and poses into a 3-scan buffer, the
    merged cloud is the same (scan i of the buffer in rows [i * ns, ...),
    time slot i, world points within 1e-5 m: the pose product's sums in
    another order), the buffer rolls and drops its oldest scan, and the
    keep mask is the newest scan's rows at logit <= 0.
  * MapMOSFilter: the same, for the scan (slot 1, index = counter) and the
    30 m-style crop of the map subsampled by Generator(counter): the same
    map points bit for bit, the same index features, the counter counting
    calls.
  * MaskFilter (no model): at voxel 0.1 on points that lie on voxel faces.
    sps_tpu quantizes p / 0.1 as XLA's reciprocal multiply, the port
    divides (ROADMAP, faults: division by a voxel size), so a point within
    a few ulps of a face may fall in the next voxel on one side. Every
    disagreement is such a point, and they are few (<= 2 % of the scan).
  * LTSFilter with seeded weights (one JAX program): the same kept
    range-image points, except points whose score lies within 1e-4 of
    epsilon; the score column within 2e-5 (tests/test_torch_lts.py's
    tolerance)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_torch_lts import flax_variables

from sps_torch.data import range_image as ri
from sps_torch.models import lts as tlts
from sps_torch.models.mapmos import MapMOSConfig as TMapCfg
from sps_torch.models.mos4d import MOS4DConfig as TMosCfg
from sps_torch.stream import baselines as tbl
from sps_torch.structs import Capacities as TCaps
from sps_tpu.models.mapmos import MapMOSConfig as JMapCfg
from sps_tpu.models.mos4d import MOS4DConfig as JMosCfg
from sps_tpu.stream import baselines as jbl
from sps_tpu.structs import Capacities as JCaps

CAPS = dict(points=2048, voxels=(1024, 512, 256, 256, 256), bricks=(64,) * 5)
NS = 256


def _pose(rng):
    a = rng.uniform(-np.pi, np.pi)
    p = np.eye(4, dtype=np.float32)
    p[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    p[:3, 3] = rng.uniform(-3, 3, 3)
    return p


def _fake_logits(xyz):
    """The stand-in network: a fixed function of the points."""
    return np.sin(3.0 * xyz[:, 0]) * np.cos(2.0 * xyz[:, 1]) - 0.2


class _Capture:
    """Replaces a port filter's model: records its inputs, returns _fake_logits."""

    def __init__(self):
        self.calls = []

    def __call__(self, pb, idx=None):
        x = pb.xyz.numpy()
        self.calls.append({"xyz": x, "t": pb.t.numpy(), "valid": pb.valid.numpy(),
                           "idx": None if idx is None else idx.numpy()})
        lg = torch.as_tensor(_fake_logits(x) * pb.valid.numpy(), dtype=torch.float32)
        return lg, {}


def _jax_capture(calls):
    def fn(variables, xyz, t, valid, idx=None):
        x = np.asarray(xyz)
        calls.append({"xyz": x, "t": np.asarray(t), "valid": np.asarray(valid),
                      "idx": None if idx is None else np.asarray(idx)})
        lg = jnp.asarray(_fake_logits(x) * np.asarray(valid), jnp.float32)
        return lg if idx is not None else (lg, jnp.zeros(5, bool))
    return fn


def _same_inputs(a, b):
    np.testing.assert_allclose(a["xyz"], b["xyz"], rtol=0, atol=1e-5)
    for k in ("t", "valid"):
        np.testing.assert_array_equal(a[k], b[k])
    if b["idx"] is not None:
        np.testing.assert_array_equal(a["idx"], b["idx"])


def test_scans_from_ckpt_name():
    for name, default in (("/x/10_scans.ckpt", 10), ("/x/5_scans_v2.ckpt", 10),
                          ("/x/best.ckpt", 7), ("4_scans", 10)):
        got = tbl.scans_from_ckpt_name(name, default)
        assert got == jbl.scans_from_ckpt_name(name, default)
    assert tbl.scans_from_ckpt_name("/x/10_scans.ckpt") == 10


def test_mos4d_buffer_rolls_like_sps_tpu():
    rng = np.random.default_rng(0)
    port = tbl.MOS4DFilter(TMosCfg(voxel_size=0.25, n_scans=3, caps=TCaps(**CAPS)),
                           _mos4d_state_dict(), NS, device="cpu")
    port.model = cap = _Capture()
    ref = jbl.MOS4DFilter(JMosCfg(voxel_size=0.25, n_scans=3, caps=JCaps(**CAPS)), None, NS)
    jcalls = []
    ref._fn = _jax_capture(jcalls)
    scans = []
    for i, n in enumerate((100, 300, 80, 256, 150)):  # 300 > NS: cut to NS
        scan = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
        pose = _pose(rng)
        scans.append((scan, pose))
        got, want = port(scan, pose), ref(scan, pose)
        assert got.dtype == bool and got.shape == want.shape == (min(n, NS),)
        np.testing.assert_array_equal(got, want)
        _same_inputs(cap.calls[-1], jcalls[-1])
        assert len(port.buffer) == len(ref.buffer) == min(i + 1, 3)
        # The newest scan sits in slot len(buffer) - 1; its keep is logit <= 0.
        o = (len(port.buffer) - 1) * NS
        lg = _fake_logits(cap.calls[-1]["xyz"][o:o + min(n, NS)])
        np.testing.assert_array_equal(got, lg <= 0)
    # After five calls the buffer holds scans 2, 3, 4 in slots 0, 1, 2.
    x = cap.calls[-1]
    for slot, (scan, pose) in enumerate(scans[2:]):
        k = min(len(scan), NS)
        world = scan[:k] @ pose[:3, :3].T + pose[:3, 3]
        np.testing.assert_allclose(x["xyz"][slot * NS:slot * NS + k], world, atol=1e-5)
        assert (x["t"][slot * NS:slot * NS + k] == slot).all()
        v = x["valid"][slot * NS:(slot + 1) * NS]
        assert v[:k].all() and not v[k:].any()


def _mos4d_state_dict():
    from sps_torch.models.mos4d import MOS4DNet

    return MOS4DNet(TMosCfg(voxel_size=0.25, n_scans=3, caps=TCaps(**CAPS))).state_dict()


def test_mapmos_crop_and_features_like_sps_tpu():
    from sps_torch.models.mapmos import MapMOSNet

    rng = np.random.default_rng(1)
    mappts = rng.uniform(-8, 8, (5000, 3)).astype(np.float32)
    nm = 512
    tcfg = TMapCfg(voxel_size=0.25, caps=TCaps(**CAPS))
    port = tbl.MapMOSFilter(tcfg, MapMOSNet(tcfg).state_dict(), mappts, NS, nm,
                            crop_radius=5.0, device="cpu")
    port.model = cap = _Capture()
    ref = jbl.MapMOSFilter(JMapCfg(voxel_size=0.25, caps=JCaps(**CAPS)), None, mappts, NS, nm,
                           crop_radius=5.0)
    jcalls = []
    ref._fn = _jax_capture(jcalls)
    for i, n in enumerate((120, 400, 60)):
        scan = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
        pose = _pose(rng)
        got, want = port(scan, pose), ref(scan, pose)
        np.testing.assert_array_equal(got, want)
        a, b = cap.calls[-1], jcalls[-1]
        _same_inputs(a, b)
        # The map rows are numpy on both sides: bit-equal.
        np.testing.assert_array_equal(a["xyz"][NS:], b["xyz"][NS:])
        m = int(a["valid"][NS:].sum())
        center = pose[:3, 3]
        inside = (np.linalg.norm(mappts - center, axis=1) < 5.0).sum()
        assert m == min(inside, nm) and inside > nm  # subsampled, not truncated
        assert (a["idx"][:min(n, NS)] == i).all() and (a["idx"][NS:NS + m] == -1).all()
        assert (a["t"][:min(n, NS)] == 1).all() and (a["t"][NS:] == 0).all()
        assert port.counter == ref.counter == i + 1


def test_mask_filter_matches_sps_tpu_except_at_voxel_faces():
    rng = np.random.default_rng(2)
    vs = 0.1
    # Map and scan points on the voxel grid's faces (multiples of 0.1), and
    # jittered ones.
    grid = rng.integers(-40, 40, (3000, 3)).astype(np.float32) * np.float32(vs)
    mappts = np.concatenate([grid[:1500], grid[:1500] + rng.normal(0, 0.03, (1500, 3))]).astype(
        np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.2, -0.3, 0.1]  # multiples of the voxel: faces stay faces
    # Posed, the scan holds map grid points, points near map points, points
    # on faces of empty voxels and random points.
    scan = np.concatenate([grid[500:1500], mappts[1500:2500] + rng.normal(0, 0.01, (1000, 3)),
                           grid[1500:2000], rng.uniform(-4, 4, (1000, 3))]) - pose[:3, 3]
    scan = scan.astype(np.float32)
    got = tbl.MaskFilter(mappts, vs, device="cpu")(scan, pose)
    want = np.asarray(jbl.MaskFilter(mappts, vs)(scan, pose))
    assert got.dtype == bool and got.shape == want.shape == (len(scan),)
    posed = scan.astype(np.float64) + pose[:3, 3].astype(np.float64)
    frac = posed / vs
    near_face = np.abs(frac - np.round(frac)).min(axis=1) < 1e-4
    diff = got != want
    assert not diff[~near_face].any()
    assert diff.sum() <= 0.02 * len(scan)
    assert got.mean() > 0.3 and (~got).mean() > 0.3
    # Exact membership on the port's own quantization.
    keys = set(map(tuple, np.floor(mappts / np.float32(vs)).astype(np.int64)))
    p = torch.as_tensor(scan) + torch.as_tensor(pose[:3, 3])
    q = np.floor((p / vs).numpy()).astype(np.int64)
    np.testing.assert_array_equal(got, [tuple(k) in keys for k in q])


def test_lts_kept_points_match_sps_tpu():
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(5000, 3)).astype(np.float32) * np.array([8, 8, 1], np.float32)
    scan = np.column_stack([pts, rng.integers(0, 2, 5000)]).astype(np.float32)
    sd = tlts.init_state_dict(seed=5)
    port = tbl.LTSFilter(sd, "vlp-16", device="cpu")
    # Epsilon at the median score of the occupied pixels: half are kept.
    wins, _ = ri.windows(ri.project(scan))
    occupied = np.abs(wins).sum(-1) > 0
    eps = float(np.median(port.scores(wins).numpy()[occupied]))
    port.eps = eps
    ref = jbl.LTSFilter(jax.tree.map(np.asarray, flax_variables(sd)), "vlp-16", epsilon=eps)
    got, want = port(scan), ref(scan)
    assert got.dtype == want.dtype == np.float32 and got.shape[1] == 4
    key = lambda a: {tuple(r) for r in a[:, :3]}  # noqa: E731
    sym = key(got) ^ key(want)
    # Points kept on one side only have scores within 1e-4 of epsilon.
    both = np.concatenate([got, want])
    for row in both:
        if tuple(row[:3]) in sym:
            assert abs(row[3] - eps) < 1e-4
    assert len(sym) <= 2
    common = [r for r in got if tuple(r[:3]) not in sym]
    wmap = {tuple(r[:3]): r[3] for r in want}
    np.testing.assert_allclose([r[3] for r in common], [wmap[tuple(r[:3])] for r in common],
                               rtol=0, atol=2e-5)
    assert (got[:, 3] <= eps).all() and 0.4 < len(got) / occupied.sum() < 0.6
