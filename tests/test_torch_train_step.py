"""The port's training step against sps_tpu's, pinned by
scripts/export_torch_assets.py (sps_torch/assets/train_step_pin.npz: sps_tpu's
grad_step on two scans of a seeded small world, f32, the atlas engine,
CONV_MODE halo, augmentation off, MinkUNet14 narrowed, LR 1e-3 halved every
step; its JAX program compiles too slowly for a test). From the pin's
initial variables the port's train_step must give, per record (the MSE
loss; STEM_ZBAND; the BCE loss; STABLE_WEIGHT 2):

  * the loss and r2, rtol 1e-5;
  * every gradient leaf (by state_dict_from_jax names), max |diff| within
    1e-4 of the leaf's max |grad| (f32 sums in another order);
  * the BN running statistics after the step, atol 1e-6;
  * the parameters after 1 (and 3) Adam steps. Adam's first step moves a
    weight by lr * g / (|g| + eps), so where the effective gradient
    (with the L2 term) exceeds 1e-5 = 1000 eps the weights agree within
    1e-6; where it is below, the move rests on gradient digits below the
    f32 noise. So over each leaf the displacement from the initial
    weights agrees within 1% (relative L2 norm), every weight within the
    moves' bound 2 * sum(lr), and the running statistics after 3 steps
    within 1e-4.

Also: the staircase schedule's LR at each step, and remat (BasicBlocks
under torch.utils.checkpoint) giving the same gradients and the same
running statistics, updated once a step (gradients within 1e-5 of each
leaf's max, the spread of the CPU's threaded reductions between runs)."""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

import sps_torch.config as tcfg_mod
from sps_torch import train
from sps_torch.convert import ASSETS, state_dict_from_jax

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_ROOT, "scripts"))
import export_torch_assets as exp  # noqa: E402

PIN = os.path.join(ASSETS, "train_step_pin.npz")


@pytest.fixture(scope="module")
def pin():
    with np.load(PIN) as z:
        return {k: z[k] for k in z.files}


def _tree(pin, prefix):
    out: dict = {}
    for k, v in pin.items():
        if k.startswith(prefix + "/"):
            *parents, leaf = k[len(prefix) + 1:].split("/")
            node = out
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = v
    return out


def _flat(pin, prefix):
    """Pinned leaves under prefix, keyed by state_dict names."""
    return {k[len(prefix) + 1:].replace("/", "."): v for k, v in pin.items()
            if k.startswith(prefix + "/")}


def _state(pin, record, **tpu):
    cfg = exp.train_config(tcfg_mod, record)
    if tpu:
        cfg = dataclasses.replace(cfg, tpu=dataclasses.replace(cfg.tpu, **tpu))
    state = train.create_state(cfg, 0, steps_per_epoch=1, device="cpu")
    init = state_dict_from_jax(_tree(pin, f"{record}/init"))
    state.model.load_state_dict(init, strict=True)
    batch = {k: torch.from_numpy(pin[f"batch/{k}"]) for k in ("xyz", "label", "valid")}
    return cfg, state, init, batch, torch.from_numpy(pin["map"])


def _check_params(sd, init, want, grads, lr_sum, first_step):
    for name, w in want.items():
        got, w0 = sd[name].numpy(), init[name].numpy()
        moved = w - w0
        rel = np.linalg.norm((got - w0) - moved) / max(np.linalg.norm(moved), 1e-30)
        assert rel <= 1e-2, (name, rel)
        assert np.abs(got - w).max() <= 2 * lr_sum, name
        if first_step:
            g_eff = np.abs(grads[name] + 1e-4 * w0)
            big = g_eff >= 1e-5
            np.testing.assert_allclose(got[big], w[big], rtol=0, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("record", list(exp.TRAIN_RECORDS))
def test_train_step_matches_sps_tpu(pin, record):
    cfg, state, init, batch, mp = _state(pin, record)
    assert not bool(pin[f"{record}/overflow"])
    steps = exp.TRAIN_RECORDS[record][2]
    lrs = []
    for i in range(steps):
        lrs.append(state.optimizer.param_groups[0]["lr"])
        m = train.train_step(state, batch, mp, cfg=cfg, augment=False)
        if i == 0:
            assert not bool(m["overflow"])
            np.testing.assert_allclose(float(m["loss"]), pin[f"{record}/loss"], rtol=1e-5)
            np.testing.assert_allclose(float(m["r2"]), pin[f"{record}/r2"], rtol=1e-5)
            grads = _flat(pin, f"{record}/grads")
            params = dict(state.model.named_parameters())
            assert grads.keys() == params.keys()
            for name, want in grads.items():
                got = params[name].grad.numpy()
                err = np.abs(got - want).max()
                assert err <= 1e-4 * max(np.abs(want).max(), 1e-12), (name, err)
            sd = {k: v.clone() for k, v in state.model.state_dict().items()}
            for name, want in _flat(pin, f"{record}/batch_stats_1").items():
                np.testing.assert_allclose(sd[name].numpy(), want, rtol=0, atol=1e-6,
                                           err_msg=name)
            _check_params(sd, init, _flat(pin, f"{record}/params_1"), grads, lrs[0], True)
    assert lrs == [1e-3 * 0.5**i for i in range(steps)]
    if steps > 1:
        sd = state.model.state_dict()
        _check_params(sd, init, _flat(pin, f"{record}/params_{steps}"), grads, sum(lrs), False)
        for name, want in _flat(pin, f"{record}/batch_stats_{steps}").items():
            np.testing.assert_allclose(sd[name].numpy(), want, rtol=0, atol=1e-4, err_msg=name)


def test_pin_records_this_configuration(pin):
    """chip_smoke.py rebuilds the configuration from the pin's meta."""
    meta = json.loads(str(pin["meta"]))
    assert meta == json.loads(json.dumps(exp.train_meta()))


def test_staircase_schedule():
    """LR * LR_DECAY ** floor(step / (steps_per_epoch * LR_EPOCH)), stepped
    per optimizer step, as optax's staircase exponential_decay."""
    cfg = exp.train_config(tcfg_mod)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, lr_epoch=2,
                                                             lr_decay=0.9))
    state = train.create_state(cfg, 0, steps_per_epoch=3, device="cpu")
    lrs = []
    for _ in range(14):
        lrs.append(state.optimizer.param_groups[0]["lr"])
        state.optimizer.step()
        state.scheduler.step()
    np.testing.assert_allclose(lrs, [1e-3 * 0.9 ** (s // 6) for s in range(14)], rtol=1e-12)


def test_remat_gives_the_same_step(pin):
    """REMAT changes memory, not math: the same loss, gradients and running
    statistics (updated once: remat's recomputation leaves them alone)."""
    out = []
    for remat in (False, True):
        cfg, state, init, batch, mp = _state(pin, "mse", remat=remat)
        assert state.model.MinkUNet.block1_0.remat is remat
        m = train.train_step(state, batch, mp, cfg=cfg, augment=False)
        out.append((float(m["loss"]),
                    {k: p.grad.clone() for k, p in state.model.named_parameters()},
                    {k: v.clone() for k, v in state.model.state_dict().items()
                     if k.endswith((".mean", ".var"))}))
    (la, ga, sa), (lb, gb, sb) = out
    assert la == lb
    # Gradients within 1e-5 of the leaf's max |grad|: the CPU's threaded
    # reductions (the conv backward's) sum in an order that varies by run.
    for k in ga:
        assert float((gb[k] - ga[k]).abs().max()) <= 1e-5 * float(ga[k].abs().max()), k
    for k in sa:
        torch.testing.assert_close(sb[k], sa[k], rtol=1e-6, atol=1e-9, msg=k)
    np.testing.assert_allclose(sa["MinkUNet.block1_0.norm1.mean"].numpy(),
                               _flat(pin, "mse/batch_stats_1")["MinkUNet.block1_0.norm1.mean"],
                               atol=1e-6)


def test_training_bypasses_the_inference_only_paths(pin):
    """In train mode INT8 is ignored (sps_tpu quantizes only at inference)
    and conv_mode zband's BasicBlocks run the unfused z-band conv and
    train-mode BN on the folded layout (the fused kernel is inference-only):
    the same loss and gradients as CONV_MODE halo without INT8 (the same
    network, summed in another order: 1e-4 of each leaf's max)."""
    out = []
    for tpu in (dict(), dict(int8=True, conv_mode="zband", zband_levels=1)):
        cfg, state, _, batch, mp = _state(pin, "mse", **tpu)
        m = train.train_step(state, batch, mp, cfg=cfg, augment=False)
        out.append((float(m["loss"]), {k: p.grad for k, p in state.model.named_parameters()}))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-5)
    for k, g in out[0][1].items():
        assert float((out[1][1][k] - g).abs().max()) <= 1e-4 * float(g.abs().max()), k
