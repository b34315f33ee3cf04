"""Data-parallel training (sps_torch/parallel/mesh.py, train.grad_step's
reductions, fit(devices > 1)) on spawned gloo ranks, f32, augmentation off:

  * a dp-2 step with the same sample on both ranks equals a one-rank
    batch-1 step (tests/test_parallel.py:77-115's check): the loss, the
    gradients (within 1e-6 of each leaf's max), the BN running statistics
    and the parameters after the update (atol 1e-7);
  * a dp-2 step on two different samples against sps_tpu's
    make_dp_train_step on a 2-device CPU mesh, pinned by
    scripts/export_torch_assets.py (sps_torch/assets/dp_step_pin.npz, the
    train pin's configuration and batch): on both ranks the loss and r2
    (rtol 1e-5), every averaged gradient leaf (within 1e-4 of its max), the
    BN statistics (atol 1e-6) and the parameters after the step, held as
    tests/test_torch_train_step.py holds them; the ranks' parameters equal;
  * fit(devices=2) through the CLI (sps_torch.scripts.train --devices 2
    --device cpu) on config_small.yaml as shipped, on a tiny synthetic
    world (one step an epoch, MAX_EPOCH 2): both epochs train and
    validate, best.pt and last.pt are written once, by rank 0;
  * fit(devices=3) with BATCH_SIZE 2 raises, as sps_tpu's."""

import json
import os

import numpy as np
import pytest
import torch
from test_torch_fit import _world
from test_torch_train_step import _check_params, _flat, _tree, exp

import sps_torch.config as tcfg_mod
from sps_torch import train
from sps_torch.convert import ASSETS, state_dict_from_jax
from sps_torch.parallel import launch
from sps_torch.parallel import mesh as pm
from sps_torch.scripts import train as train_cli

PIN = os.path.join(ASSETS, "dp_step_pin.npz")
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pin():
    with np.load(PIN) as z:
        return {k: z[k] for k in z.files}


def _state(pin, cfg):
    state = train.create_state(cfg, 0, steps_per_epoch=1, device="cpu")
    state.model.load_state_dict(state_dict_from_jax(_tree(pin, "init")), strict=True)
    return state


def _result(state, m):
    return {"loss": float(m["loss"]), "r2": float(m["r2"]), "overflow": bool(m["overflow"]),
            "grads": {k: p.grad.numpy().copy() for k, p in state.model.named_parameters()},
            "state": {k: v.numpy().copy() for k, v in state.model.state_dict().items()}}


def dp_rank(rank, world):
    """On every rank: a dp step on [sample 0, sample 0] and one on the pin's
    two samples; on rank 0 also the one-rank step on sample 0 alone."""
    pin = _pin()
    cfg = exp.train_config(tcfg_mod)
    mesh = pm.make_mesh(world, "dp")
    step = pm.make_dp_train_step(cfg, mesh, augment=False)
    batch = {k: torch.from_numpy(pin[f"batch/{k}"]) for k in ("xyz", "label", "valid")}
    mp = torch.from_numpy(pin["map"])
    same = {k: torch.cat([v[:1], v[:1]]) for k, v in batch.items()}
    out = {}
    for tag, b in (("same", same), ("pin", batch)):
        state = _state(pin, cfg)
        out[tag] = _result(state, step(state, b, mp))
    if rank == 0:
        state = _state(pin, cfg)
        one = {k: v[:1] for k, v in batch.items()}
        out["one"] = _result(state, train.train_step(state, one, mp, cfg=cfg, augment=False))
    return out


@pytest.fixture(scope="module")
def ranks():
    return launch.spawn(dp_rank, 2, timeout=300.0)


def test_dp_same_sample_equals_one_rank(ranks):
    one = ranks[0]["one"]
    for r, res in enumerate(ranks):
        got = res["same"]
        assert not got["overflow"]
        np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-6)
        for k, g in one["grads"].items():
            assert np.abs(got["grads"][k] - g).max() <= 1e-6 * max(np.abs(g).max(), 1e-12), (r, k)
        for k, v in one["state"].items():
            np.testing.assert_allclose(got["state"][k], v, rtol=0, atol=1e-7,
                                       err_msg=f"rank {r} {k}")


def test_dp_step_matches_sps_tpu(ranks):
    pin = _pin()
    assert not bool(pin["overflow"])
    init = state_dict_from_jax(_tree(pin, "init"))
    grads = _flat(pin, "grads")
    lr = exp.TRAIN_HP["lr"]
    for r, res in enumerate(ranks):
        got = res["pin"]
        np.testing.assert_allclose(got["loss"], pin["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["r2"], pin["r2"], rtol=1e-5)
        assert got["grads"].keys() == grads.keys()
        for k, want in grads.items():
            err = np.abs(got["grads"][k] - want).max()
            assert err <= 1e-4 * max(np.abs(want).max(), 1e-12), (r, k, err)
        sd = {k: torch.from_numpy(v) for k, v in got["state"].items()}
        for k, want in _flat(pin, "batch_stats_1").items():
            np.testing.assert_allclose(sd[k].numpy(), want, rtol=0, atol=1e-6, err_msg=k)
        _check_params(sd, init, _flat(pin, "params_1"), grads, lr, True)
    for k, v in ranks[0]["pin"]["state"].items():
        np.testing.assert_array_equal(ranks[1]["pin"]["state"][k], v, err_msg=k)


def test_pin_records_this_configuration():
    assert json.loads(str(_pin()["meta"])) == json.loads(json.dumps(exp.train_meta()))


def _fit_args(tmp_path):
    root = _world(str(tmp_path / "w"), {"20220420": 1, "20220601": 1, "20220608": 1})
    ckpt_dir, log_dir = tmp_path / "c", tmp_path / "l"
    return ckpt_dir, log_dir, ["-c", os.path.join(_ROOT, "config", "config_small.yaml"),
                               "--data", root, "--ckpt-dir", str(ckpt_dir), "--log-dir",
                               str(log_dir), "--devices", "2", "--device", "cpu"]


def _check_fit_outputs(ckpt_dir, log_dir):
    assert os.path.isfile(ckpt_dir / "best.pt") and os.path.isfile(ckpt_dir / "last.pt")
    with open(log_dir / "SMOKE.jsonl") as f:
        lines = [json.loads(line) for line in f]
    vals = [x for x in lines if "val_loss" in x]
    assert [x["epoch"] for x in vals] == [0, 1]
    assert all(np.isfinite(x["val_loss"]) for x in vals)
    assert [x["step"] for x in lines if "train_loss" in x] == [1]


@pytest.mark.limit(600)  # 154 s on a worker of -n 6 (8 CPUs)
def test_fit_devices_2_through_the_cli(tmp_path):
    ckpt_dir, log_dir, args = _fit_args(tmp_path)
    best = train_cli.main(args)
    assert best == str(ckpt_dir / "best.pt")
    _check_fit_outputs(ckpt_dir, log_dir)


def test_fit_devices_must_divide_the_batch(tmp_path):
    with pytest.raises(ValueError, match="not divisible by devices 3"):
        train_cli.main(["-c", os.path.join(_ROOT, "config", "config_small.yaml"),
                        "--data", str(tmp_path), "--devices", "3", "--device", "cpu"])
