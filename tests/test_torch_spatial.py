"""Spatial sharding (sps_torch/parallel/spatial.py) on 2 and 4 gloo ranks,
spawned (parallel/launch.py: a free port, a timeout on the ranks, the first
failure raised with its traceback), against the port's one-rank forward and
sps_tpu's single-device one, f32, on tests/test_spatial.py's slab world
(tests/test_torch_sp_plan.py holds the sliced tables to sps_tpu's):

  * the sp forward with ghost_frac 0 (per-conv all-gather) and 7.0 (ghost
    exchange, every remote row fits), on the aliased pyramid (row_from 3)
    and the all-brick one: every rank's scores within 1e-5 of the one-rank
    forward and within rtol 1e-3 / atol 1e-4 of sps_tpu's, no overflow;
  * ghost_frac 1e-9: the overflow flag raised on every rank
    (tests/test_spatial.py:112-125);
  * the sp StreamingFilter (2 ranks) against the unsharded one: scores
    within 1e-5, the same keep mask away from epsilon, equal counts;
  * a train-mode step under sp (2 and 4 ranks) and the one-rank step,
    against sps_tpu's grad_step(sp_axis="sp") under shard_map on 2 and 4
    CPU devices and its unsharded grad_step, with
    tests/test_torch_train_step.py's tolerances: the loss and r2 (rtol
    1e-5), every gradient leaf summed over sp (within 1e-4 of its max) and
    the BN running statistics (atol 1e-6); the sp loss and statistics also
    equal the one-rank step's (rtol 1e-5 / atol 1e-6). sps_tpu's sp
    gradient is n_sp times its unsharded one: the replicated loss reaches
    each rank's block through the output all-gather's transpose, a
    reduce-scatter of the ranks' equal cotangents, and grad_step sums over
    sp; the port holds the same.

sps_tpu's results are pinned by scripts/export_torch_assets.py --only sp:
its single-device forward (sps_torch/assets/sp_scores_pin.npz; its JAX
program takes ~30 s a form to compile) and its training steps
(sp_step_pin.npz, on the configuration and batch of sp_step_config and
sp_step_inputs, from its initial variables). The 2- and 4-rank runs start
together."""

import concurrent.futures
import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from sps_torch import config as tcfg_mod
from sps_torch import train
from sps_torch.models import spsnet as tsps
from sps_torch.convert import ASSETS
from sps_torch.parallel import launch
from sps_torch.parallel import mesh as pm
from sps_torch.parallel import spatial as sp
from sps_torch.structs import pad_point_batch as tpad

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
import export_torch_assets as exp  # noqa: E402
from test_torch_train_step import _flat, _tree  # noqa: E402

from sps_torch.convert import state_dict_from_jax  # noqa: E402

CAPS, FORMS = exp.SP_CAPS, exp.SP_FORMS
PIN = os.path.join(ASSETS, "sp_scores_pin.npz")
STEP_PIN = os.path.join(ASSETS, "sp_step_pin.npz")

FRACS = (0.0, 7.0)
NARROW = dict(init_dim=4, planes=(4, 8, 8, 8, 8, 8, 8, 4))
TIMEOUT = 300.0


class NarrowConfig(tcfg_mod.Config):
    """A Config whose MinkUNet is narrowed (the CPU cost)."""

    def sps_config(self, batch_size=None):
        s = super().sps_config(batch_size)
        return dataclasses.replace(s, unet=dataclasses.replace(s.unet, **NARROW))


def filter_config():
    """tests/test_spatial.py's streaming configuration (atlas, side 8,
    halo, row levels from L3), narrowed."""
    return NarrowConfig(
        data=tcfg_mod.DataConfig(root="/tmp"), train=tcfg_mod.TrainConfig(batch_size=1),
        voxel_size=0.2, tpu=tcfg_mod.TPUConfig(
            scan_points=1024, submap_points=1024, cell_capacity=4096,
            voxels=(4096, 2048, 1024, 512, 256), bricks=(1024, 512, 256, 256, 256),
            engine="atlas", brick_side=8, atlas_extent=(16, 16, 16), conv_mode="halo",
            row_from=3))


def _model(cfg, sd):
    m = tsps.SPSModel(cfg)
    m.load_state_dict(sd, strict=True)
    return m.eval()


def forward_rank(rank, world, with_extras):
    """One rank's sp forwards and training step (and on rank 0 the one-rank
    ones); with_extras also the filter."""
    mesh = pm.make_mesh(world, "sp")
    pb = tpad(*exp.sp_points(), CAPS["points"], device="cpu")
    out = {}
    for form, row_from in FORMS.items():
        cfg = exp.sp_configs(row_from)[1]
        sd = tsps.init_state_dict(cfg, seed=exp.SP_WEIGHTS_SEED)
        fracs = FRACS + ((1e-9,) if row_from else ())
        with torch.inference_mode():
            if rank == 0:
                out[f"{form}/one"] = _model(cfg, sd)(pb)[0].numpy()
            for frac in fracs:
                s, aux = _model(sp.sp_config(cfg, "sp", frac), sd)(pb)
                out[f"{form}/{frac}"] = s.numpy()
                out[f"{form}/{frac}/overflow"] = aux["overflow"].numpy()
    if with_extras:
        out.update(filter_rank(mesh))
    out.update(train_rank(rank))
    return out


def filter_rank(mesh):
    from sps_torch.stream.engine import StreamingFilter

    cfg = filter_config()
    sd = tsps.init_state_dict(cfg.sps_config(1), seed=0)
    rng = np.random.default_rng(3)
    n = 700
    scan = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    mp = np.concatenate([scan[: n // 2] + rng.normal(0, 0.02, (n // 2, 3)).astype(np.float32),
                         rng.uniform(5, 9, (2000, 3)).astype(np.float32)])
    ns = cfg.tpu.scan_points
    sx = np.zeros((ns, 3), np.float32)
    sx[:n] = scan
    sv = np.arange(ns) < n
    sl = (rng.random(ns) < 0.3).astype(np.float32)
    args = (sx, sv, sl, np.eye(4, dtype=np.float32))
    out = {}
    for tag, kw in (("one", {}), ("sp", dict(mesh=mesh))):
        scores, keep, stats = StreamingFilter(cfg, sd, mp, device="cpu", **kw)(*args)
        out[f"filter/{tag}"] = (scores.numpy(), keep.numpy(),
                                {k: float(v) for k, v in stats.items()})
    return out


def _step_pin():
    with np.load(STEP_PIN) as z:
        return {k: z[k] for k in z.files}


def train_rank(rank):
    pin = _step_pin()
    cfg = exp.sp_step_config(tcfg_mod)
    batch = {k: torch.from_numpy(pin[f"batch/{k}"]) for k in ("xyz", "label", "valid")}
    mp = torch.from_numpy(pin["map"])
    init = state_dict_from_jax(_tree(pin, "init"))
    out = {}
    for tag, sp_axis in (("one", None), ("sp", "sp")):
        if tag == "one" and rank != 0:
            continue
        state = train.create_state(cfg, 0, 1, "cpu", sp_axis=sp_axis)
        state.model.load_state_dict(init, strict=True)
        m = train.grad_step(state, batch, mp, cfg=cfg, augment=False, sp_axis=sp_axis)
        out[f"train/{tag}"] = (
            float(m["loss"]), float(m["r2"]), bool(m["overflow"]),
            {k: p.grad.numpy().copy() for k, p in state.model.named_parameters()},
            {k: v.numpy().copy() for k, v in state.model.named_buffers()})
    return out


@pytest.fixture(scope="module")
def runs():
    with np.load(PIN) as z:
        want = {form: z[f"{form}/scores"] for form in FORMS}
        assert not any(z[f"{form}/overflow"].any() for form in FORMS)
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        f2 = ex.submit(launch.spawn, forward_rank, 2, True, timeout=TIMEOUT)
        f4 = ex.submit(launch.spawn, forward_rank, 4, False, timeout=TIMEOUT)
        return {2: f2.result(), 4: f4.result()}, want


@pytest.mark.parametrize("frac", FRACS, ids=["gather", "ghost"])
@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("world", [2, 4])
def test_sp_forward_matches_one_rank_and_sps_tpu(runs, world, form, frac):
    ranks, want = runs
    one = ranks[world][0][f"{form}/one"]
    valid = np.zeros_like(one, bool)
    valid[: len(exp.sp_points()[0])] = True
    assert (one[valid] > 0).all() and (one[~valid] == 0).all()
    np.testing.assert_allclose(one, want[form], rtol=1e-3, atol=1e-4)
    for r, res in enumerate(ranks[world]):
        got = res[f"{form}/{frac}"]
        assert not res[f"{form}/{frac}/overflow"].any(), r
        np.testing.assert_allclose(got, one, rtol=0, atol=1e-5, err_msg=f"rank {r}")
        np.testing.assert_allclose(got, want[form], rtol=1e-3, atol=1e-4, err_msg=f"rank {r}")


@pytest.mark.parametrize("world", [2, 4])
def test_ghost_overflow_is_reported(runs, world):
    ranks, _ = runs
    for res in ranks[world]:
        assert res["row_from3/1e-09/overflow"].any()


def test_sp_streaming_filter_matches_unsharded(runs):
    ranks, _ = runs
    s1, k1, st1 = ranks[2][0]["filter/one"]
    eps = filter_config().threshold
    for res in ranks[2]:
        s, k, st = res["filter/sp"]
        np.testing.assert_allclose(s, s1, rtol=0, atol=1e-5)
        far = np.abs(s1 - eps) > 1e-3
        np.testing.assert_array_equal(k[far], k1[far])
        for name in ("n_scan_voxels", "n_submap_voxels", "n_kept", "overflow"):
            assert st[name] == st1[name], name
        assert st["overflow"] == 0
        np.testing.assert_allclose(st["dIoU"], st1["dIoU"], atol=1e-6)


def _check_step(got, pin, n, tag):
    """A step's (loss, r2, overflow, grads, buffers) against sps_tpu's on n
    devices, with tests/test_torch_train_step.py's tolerances."""
    loss, r2, ov, g, b = got
    assert not ov and not bool(pin[f"{n}/overflow"]), tag
    np.testing.assert_allclose(loss, pin[f"{n}/loss"], rtol=1e-5, err_msg=tag)
    np.testing.assert_allclose(r2, pin[f"{n}/r2"], rtol=1e-5, err_msg=tag)
    grads = _flat(pin, f"{n}/grads")
    assert g.keys() == grads.keys(), tag
    for k, want in grads.items():
        err = np.abs(g[k] - want).max()
        assert err <= 1e-4 * max(np.abs(want).max(), 1e-12), (tag, k, err)
    for k, want in _flat(pin, f"{n}/batch_stats_1").items():
        np.testing.assert_allclose(b[k], want, rtol=0, atol=1e-6, err_msg=f"{tag} {k}")


def _check_sp_steps(runs, world):
    ranks, _ = runs
    pin = _step_pin()
    one = ranks[world][0]["train/one"]
    _check_step(one, pin, 1, "one rank")
    for r, res in enumerate(ranks[world]):
        got = res["train/sp"]
        _check_step(got, pin, world, f"sp {world} rank {r}")
        np.testing.assert_allclose(got[0], one[0], rtol=1e-5)
        for k, v in one[4].items():
            np.testing.assert_allclose(got[4][k], v, rtol=1e-5, atol=1e-6, err_msg=k)


def test_sp_train_step_matches_one_rank(runs):
    _check_sp_steps(runs, 2)


def test_sp_train_step_4_ranks_matches_sps_tpu(runs):
    _check_sp_steps(runs, 4)


def test_sp_step_pin_records_this_configuration():
    assert json.loads(str(_step_pin()["meta"])) == json.loads(json.dumps(exp.sp_step_meta()))
    # The port's dry-run configuration at the pin's voxel size.
    want = dataclasses.replace(pm.dryrun_config(), voxel_size=exp.SP_STEP_VOXEL)
    got = exp.sp_step_config(tcfg_mod)
    assert (got.tpu, got.train, got.voxel_size) == (want.tpu, want.train, want.voxel_size)
