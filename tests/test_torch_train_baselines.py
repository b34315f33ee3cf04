"""The port's baseline trainers (sps_torch/scripts/train_baselines.py) and the
train mode of its baseline models against sps_tpu's.

sps_torch/assets/baseline_train_pin.npz (scripts/export_torch_assets.py
--only baseline_train) holds one step of each of scripts/train_baselines.py's
trainers as the script runs them, from the port trainers' seeded initial
weights, on a tiny seeded dataset with config_loc.yaml at voxel 0.25 and 64
bricks a level (LTS with dropout 0: flax's dropout bits cannot be drawn in
torch), and MOS4D a second time with level 0's occupancy in f32
("mos4d_f32"). Against it (no JAX program here, the file takes ~40 s):

  * the port's samplers draw the script's batches bit for bit (same
    generators, same order, the init draws included);
  * one port step of MOS4D in f32, MapMOS and LTS from the same weights on
    the same batch: the loss (rtol 1e-5); every gradient leaf: its pinned
    entries within 1e-4 of the leaf's max |grad| (a leaf whose gradient is
    below 1e-3 of the model's largest, such as a bias ahead of a BN whose
    gradient is 0 up to f32 noise, against that floor instead), its max
    |grad| and sum of squares (rtol 1e-4, same floor); the parameters
    after the Adam step (Adam's first move is lr * g / (|g| + eps), so a
    weight with a gradient within f32 noise of 0 may move up to 2 lr
    apart: the entries within 2 lr, and the displacement of the entries
    whose gradient stands above the noise within 1% relative L2); the BN
    running statistics after it (atol 1e-5);
  * MOS4D as it trains, in bf16: its gradients carry bf16 rounding through
    train-mode BN, so it is held in a band set between what the port's bf16
    step reads against the pin's bf16 step and how far the port's own bf16
    step lies from its f32 one (mos4d against mos4d_f32; both read by
    test_mos4d_bf16_step_within_its_band, the same on 1, 2 and 4 CPU
    threads):

        measure (pinned gradient entries of    port bf16 vs   port bf16 vs   limit
        all leaves together)                   pin bf16       port f32
        loss, relative                         1.37e-3        2.15e-3        2^-9
        gradient cosine                        0.9275         0.9164         >= 0.92
        gradient relative L2                   0.3850         0.4181         <= 0.40
        running statistics, of their scale    1.597e-3       1.656e-3       1.63e-3

    and its parameters after the step are Adam's first step of its own
    gradient, -lr g / (|g| + eps), within 1e-3 relative L2.

Also: BN1d's train mode against sps_tpu's BN1d (one small JAX program),
dropout's semantics, the trainers' .pt checkpoints through
run_localization(..., baseline_weights=DIR), and the ambiguous directory."""

import dataclasses
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from sps_torch.convert import ASSETS
from sps_torch.models import lts as tlts
from sps_torch.scripts import train_baselines as tb
from sps_torch.stream import localize as tloc

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_ROOT, "scripts"))
import export_torch_assets as exp  # noqa: E402

PIN = os.path.join(ASSETS, "baseline_train_pin.npz")
MODELS = ("mos4d", "mapmos", "lts")
STEPS = ("mos4d_f32", "mos4d", "mapmos", "lts")
TIGHT = ("mos4d_f32", "mapmos", "lts")
NOISE_FLOOR = 1e-3  # of the model's largest gradient
# MOS4D as it trains (bf16): the band it is held in (the module docstring
# has the readings each limit lies between).
MOS4D_LOSS_BAND = 2.0**-9
MOS4D_GRAD_COSINE = 0.92
MOS4D_GRAD_REL_L2 = 0.40
MOS4D_STATS_BAND = 1.63e-3
ADAM_FIRST_STEP_REL = 1e-3


@pytest.fixture(scope="module")
def pin():
    with np.load(PIN) as z:
        p = {k: z[k] for k in z.files}
    p["meta"] = json.loads(str(p["meta"]))
    return p


def _dataset(pin):
    cuts = np.cumsum(pin["scan_sizes"])[:-1]
    scans = np.split(pin["scans"], cuts)
    return scans, list(pin["poses"]), pin["map"]


def _batches(name, pin):
    m = pin["meta"]
    scans, poses, mp = _dataset(pin)
    return {"mos4d": lambda: tb.mos4d_batches(scans, poses, m["n_scans"], m["ns"], m["seed"]),
            "mapmos": lambda: tb.mapmos_batches(scans, poses, mp, m["ns"], m["nm"], m["seed"]),
            "lts": lambda: tb.lts_batches(scans, m["seed"])}[name]()


def _flax_name(name, model):
    """A port parameter/buffer name -> the pin's flat flax name and whether
    the tensor is transposed there (LTS's Linear weights)."""
    *path, leaf = name.split(".")
    coll = "batch_stats" if leaf in ("mean", "var") else "params"
    if model == "lts" and leaf == "weight":
        return "/".join([coll, *path, "kernel"]), True
    return "/".join([coll, *path, leaf]), False


@pytest.mark.parametrize("name", MODELS)
def test_sampled_batches_bit_equal(pin, name):
    got = next(_batches(name, pin))
    want = [pin[f"{name}/batch/{i}"] for i in range(len(got))]
    assert f"{name}/batch/{len(got)}" not in pin
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def steps(pin):
    """One port step of each record's model on the pin's batch (CPU)."""
    out = {}
    for name in STEPS:
        batch = tuple(pin[f"{name}/batch/{i}"] for i in range(6)
                      if f"{name}/batch/{i}" in pin)
        out[name] = tb.pin_step(name, batch, pin["meta"], "cpu")
        out[name]["gmax"] = max(float(g.abs().max()) for g in out[name]["grads"].values())
    return out


def _pinned(pin, name, prefix, flax_name):
    """A parameter leaf's pinned entries and stats (the gradient and
    parameter trees are rooted at "params")."""
    leaf = flax_name[len("params/"):]
    return pin[f"{name}/{prefix}/{leaf}"], pin[f"{name}/{prefix}_stats/{leaf}"]


def _model_kind(name):
    return name.removesuffix("_f32")


@pytest.mark.parametrize("name", TIGHT)
def test_loss_matches_sps_tpu(pin, steps, name):
    want = float(pin[f"{name}/loss"])
    np.testing.assert_allclose(steps[name]["loss"], want, rtol=1e-5)
    assert np.isfinite(want) and want > 0


@pytest.mark.parametrize("name", TIGHT)
def test_gradients_match_sps_tpu(pin, steps, name):
    grads, floor = steps[name]["grads"], NOISE_FLOOR * steps[name]["gmax"]
    seen = set()
    for k, g in grads.items():
        fname, transposed = _flax_name(k, _model_kind(name))
        g = g.T if transposed else g
        want, (maxabs, _, sumsq, size) = _pinned(pin, name, "grads", fname)
        seen.add(fname[len("params/"):])
        assert g.numel() == size, k
        scale = max(maxabs, floor)
        err = np.abs(exp.pin_sample(g.numpy()) - want).max()
        assert err <= 1e-4 * scale, (k, err, maxabs)
        assert abs(float(g.abs().max()) - maxabs) <= 1e-4 * scale, k
        assert abs(float((g.double() ** 2).sum()) - sumsq) <= 1e-4 * scale**2 * size, k
    pinned = {k.split("/", 2)[2] for k in pin if k.startswith(f"{name}/grads/")}
    assert seen == pinned
    # The loss reaches all but a few parameters above the noise floor.
    live = sum(float(g.abs().max()) > floor for g in grads.values())
    assert live >= 0.8 * len(grads), (live, len(grads))


@pytest.mark.parametrize("name", TIGHT)
def test_adam_step_matches_sps_tpu(pin, steps, name):
    lr = tb.LR[_model_kind(name)]
    floor = NOISE_FLOOR * steps[name]["gmax"]
    for k, g in steps[name]["grads"].items():
        fname, transposed = _flax_name(k, _model_kind(name))
        w0, w1 = steps[name]["init"][k], steps[name]["after"][k]
        w0, w1 = (w0.T, w1.T) if transposed else (w0, w1)
        want, (_, wsum, _, _) = _pinned(pin, name, "params_1", fname)
        got = exp.pin_sample(w1.numpy())
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * lr + 1e-6, err_msg=k)
        assert abs(float(w1.double().sum()) - wsum) <= 2 * lr * w1.numel() + 1e-4, k
        # Where the pinned gradient stands above the f32 noise (1e-3 of the
        # leaf's max and above the floor), the moves agree within 1%.
        g_pin, (maxabs, _, _, _) = _pinned(pin, name, "grads", fname)
        live = np.abs(g_pin) > max(1e-3 * maxabs, floor)
        if live.any():
            start = exp.pin_sample(w0.numpy())[live]
            d_want = want[live] - start
            rel = np.linalg.norm((got[live] - start) - d_want) / np.linalg.norm(d_want)
            assert rel <= 0.01, (k, rel)


@pytest.mark.parametrize("name", STEPS)
def test_running_statistics_match_sps_tpu(pin, steps, name):
    after = steps[name]["after"]
    n = 0
    for k, v in after.items():
        fname, _ = _flax_name(k, _model_kind(name))
        if not fname.startswith("batch_stats/"):
            continue
        want = pin[f"{name}/batch_stats_1/{fname[len('batch_stats/'):]}"]
        atol = MOS4D_STATS_BAND * max(np.abs(want).max(), 1.0) if name == "mos4d" else 1e-5
        np.testing.assert_allclose(v.numpy(), want, rtol=0, atol=atol, err_msg=k)
        assert not torch.equal(v, steps[name]["init"][k]), f"{k} did not move"
        n += 1
    assert n >= 2


def _sampled_grads(step):
    """A step's gradient leaves as the pin samples them, concatenated."""
    return np.concatenate([exp.pin_sample(g.numpy()) for g in step["grads"].values()])


def _cosine_rel(a, b):
    return a @ b / (np.linalg.norm(a) * np.linalg.norm(b)), np.linalg.norm(a - b) / np.linalg.norm(b)


def _stats_err(after, want):
    """The largest running-statistics difference, of its leaf's scale."""
    return max(float(np.abs(v.numpy() - want(k)).max() / max(np.abs(want(k)).max(), 1.0))
               for k, v in after.items()
               if _flax_name(k, "mos4d")[0].startswith("batch_stats/"))


def test_mos4d_bf16_step_within_its_band(pin, steps):
    """MOS4D as it trains (bf16): loss and gradients within the band, which
    lies between this reading and the port's own bf16-to-f32 gap."""
    bf16, f32 = steps["mos4d"], steps["mos4d_f32"]
    want = np.concatenate([_pinned(pin, "mos4d", "grads", _flax_name(k, "mos4d")[0])[0]
                           for k in bf16["grads"]])
    got = _sampled_grads(bf16)
    cos, rel = _cosine_rel(got, want)
    gap_cos, gap_rel = _cosine_rel(got, _sampled_grads(f32))
    loss_rel = abs(bf16["loss"] - float(pin["mos4d/loss"])) / float(pin["mos4d/loss"])
    gap_loss = abs(bf16["loss"] - f32["loss"]) / f32["loss"]
    stats = _stats_err(bf16["after"], lambda k: pin[
        f"mos4d/batch_stats_1/{_flax_name(k, 'mos4d')[0][len('batch_stats/'):]}"])
    gap_stats = _stats_err(bf16["after"], lambda k: f32["after"][k].numpy())
    print(f"MOS4D bf16 vs pin bf16 (vs port f32): loss {loss_rel:.3e} ({gap_loss:.3e}), "
          f"cosine {cos:.4f} ({gap_cos:.4f}), relative L2 {rel:.4f} ({gap_rel:.4f}), "
          f"statistics {stats:.4e} ({gap_stats:.4e})")
    assert loss_rel <= MOS4D_LOSS_BAND < gap_loss
    assert cos >= MOS4D_GRAD_COSINE > gap_cos
    assert rel <= MOS4D_GRAD_REL_L2 < gap_rel
    assert stats <= MOS4D_STATS_BAND < gap_stats
    # The step's parameters are Adam's first step of its own gradient.
    lr, eps = tb.LR["mos4d"], tb.ADAM["eps"]
    moved = torch.cat([(bf16["after"][k] - bf16["init"][k]).reshape(-1).double()
                       for k in bf16["grads"]])
    adam = torch.cat([(-lr * g / (g.abs() + eps)).reshape(-1).double()
                      for g in bf16["grads"].values()])
    assert float((moved - adam).norm() / adam.norm()) <= ADAM_FIRST_STEP_REL


def test_bn1d_train_mode_matches_sps_tpu():
    """BN1d in training: f32 statistics over (B, N), biased variance to
    normalize, unbiased variance in the running average (momentum 0.1),
    the input dtype kept; against sps_tpu's BN1d on the same input."""
    import jax

    from sps_tpu.models import lts as jlts

    rng = np.random.default_rng(3)
    x = (rng.normal(size=(3, 50, 8)) * 2 + 0.5).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bias = rng.normal(size=8).astype(np.float32)
    mean0 = rng.normal(size=8).astype(np.float32)
    var0 = rng.uniform(0.5, 2.0, 8).astype(np.float32)
    bn = jlts.BN1d(8)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    want, mut = jax.jit(lambda v, a: bn.apply(v, a, True, mutable=["batch_stats"]))(variables, x)
    m = tlts.BN1d(8).train()
    with torch.no_grad():
        m.scale.copy_(torch.as_tensor(scale))
        m.bias.copy_(torch.as_tensor(bias))
        m.mean.copy_(torch.as_tensor(mean0))
        m.var.copy_(torch.as_tensor(var0))
        got = m(torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(m.mean.numpy(), np.asarray(mut["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(m.var.numpy(), np.asarray(mut["batch_stats"]["var"]),
                               rtol=1e-6, atol=1e-6)
    n = 3 * 50
    np.testing.assert_allclose(m.var.numpy(),
                               0.9 * var0 + 0.1 * x.reshape(n, 8).var(0) * n / (n - 1),
                               rtol=1e-5)
    assert got.dtype == torch.float32
    # bf16 in, bf16 out; eval mode reads the running statistics.
    assert m(torch.as_tensor(x).bfloat16()).dtype == torch.bfloat16
    m.eval()
    with torch.no_grad():
        ev = m(torch.as_tensor(x))
    np.testing.assert_allclose(ev.numpy(), (x - m.mean.numpy()) / np.sqrt(m.var.numpy() + 1e-5)
                               * scale + bias, rtol=1e-5, atol=1e-5)


def test_dropout_semantics():
    x = torch.rand(400, 500) + 0.5
    g = torch.Generator().manual_seed(5)
    assert torch.equal(tlts.dropout(x, 0.2, False, g), x)  # eval: the identity
    assert torch.equal(tlts.dropout(x, 0.0, True, None), x)
    y = tlts.dropout(x, 0.2, True, g)
    kept = y != 0
    assert abs(1 - kept.float().mean().item() - 0.2) <= 0.01
    assert torch.equal(y[kept], x[kept] / 0.8)
    again = tlts.dropout(x, 0.2, True, torch.Generator().manual_seed(5))
    assert torch.equal(y, again)  # the mask is the generator's, not torch's global RNG
    with pytest.raises(ValueError, match="Generator"):
        tlts.dropout(x, 0.2, True, None)
    # In the model: identity in eval mode (same scores with any generator),
    # and two dropout layers after l2 / l3 in training.
    model = tlts.SPCTReg()
    model.load_state_dict(tlts.init_state_dict(0))
    model.eval()
    w = torch.rand(2, 64, 3)
    with torch.no_grad():
        assert torch.equal(model(w), model(w, torch.Generator().manual_seed(1)))
        model.train()
        a = model(w, torch.Generator().manual_seed(1))
        b = model(w, torch.Generator().manual_seed(1))
        c = model(w, torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)


def _write_dataset(root, pin, seq="20220629"):
    """The pin's dataset in the BLT layout (sensor-frame scans, poses, map)."""
    scans, poses, mp = _dataset(pin)
    sdir = os.path.join(root, "sequence", seq)
    os.makedirs(os.path.join(root, "maps"), exist_ok=True)
    os.makedirs(os.path.join(sdir, "scans"))
    os.makedirs(os.path.join(sdir, "poses"))
    np.save(os.path.join(root, "maps", "base_map.asc.npy"),
            np.concatenate([mp, np.zeros((len(mp), 1), np.float32)], 1))
    np.savetxt(os.path.join(sdir, "map_transform"), np.eye(4), delimiter=",")
    for i, (sc, p) in enumerate(zip(scans, poses)):
        np.save(os.path.join(sdir, "scans", f"{i:06d}.npy"), sc)
        np.savetxt(os.path.join(sdir, "poses", f"{i:06d}.txt"), p, delimiter=",")


def test_checkpoints_load_through_baseline_weights(pin, tmp_path):
    """The trainers write <out>/<model>.pt (+ sidecar); run_localization's
    --baseline-weights reads them (strict state_dict load), the round-5
    npz still load, and a directory holding both forms for one model, or
    two npz, raises."""
    m = pin["meta"]
    scans, poses, mp = _dataset(pin)
    cfg = tb.pin_config(m)
    out = str(tmp_path / "baselines")
    paths = {
        "mos4d": tb.train_mos4d(cfg, scans, poses, True, 1, m["n_scans"], m["ns"], out,
                                m["seed"], device="cpu"),
        "mapmos": tb.train_mapmos(cfg, scans, poses, mp, 1, m["ns"], m["nm"], out, m["seed"],
                                  device="cpu"),
        "lts": tb.train_lts(cfg, scans, 1, out, m["seed"], device="cpu")}
    for name, (path, losses) in paths.items():
        assert path == os.path.join(out, f"{name}.pt") and os.path.exists(path + ".config.json")
        assert len(losses) == 1 and np.isfinite(losses[0])
        sd = tloc._baseline_state_dict(out, name)
        model = tb.pin_model(name, m)[0]
        model.load_state_dict(sd, strict=True)
        init = tb.pin_model(name, m)[0].state_dict()
        assert any(not torch.equal(sd[k], init[k]) for k in init), name
    # The trained models as run_localization's filters, and one LTS
    # localization of the pin's sequence from the checkpoint directory.
    data = str(tmp_path / "data")
    _write_dataset(data, pin)
    lcfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, root=data),
                               tpu=dataclasses.replace(cfg.tpu, scan_points=1024))
    for name in ("mos4d", "mapmos"):
        filt = tloc._make_baseline_filter(lcfg, name, mp, weights_dir=out, device="cpu")
        assert filt is not None
    r = tloc.run_localization(lcfg, {}, "20220629", "lts", prior="odom",
                              baseline_weights=out, log=lambda s: None, device="cpu")
    assert np.isfinite(r["ate_rmse"]) and len(r["poses"]) == len(scans)
    # The round-5 exports still load from sps_torch/assets.
    assert tloc._baseline_state_dict(ASSETS, "lts").keys() == tlts.SPCTReg().state_dict().keys()
    # Ambiguous directories raise.
    shutil.copy(os.path.join(ASSETS, "baselines_r5_lts.npz"), out)
    with pytest.raises(FileExistsError, match="ambiguous"):
        tloc._baseline_state_dict(out, "lts")
    two = tmp_path / "two"
    two.mkdir()
    for tag in ("a", "b"):
        shutil.copy(os.path.join(ASSETS, "baselines_r5_lts.npz"), two / f"{tag}_lts.npz")
    with pytest.raises(FileNotFoundError):
        tloc._baseline_state_dict(str(two), "lts")


def test_pin_records_this_configuration(pin):
    m = pin["meta"]
    assert {k: v for k, v in m.items() if k != "pin_sample"} == exp.BT_META
    assert m["pin_sample"] == exp.PIN_SAMPLE
    scans, poses, mp = exp.baseline_train_inputs(exp.BT_META)
    got_scans, got_poses, got_map = _dataset(pin)
    np.testing.assert_array_equal(np.concatenate(scans), np.concatenate(got_scans))
    np.testing.assert_array_equal(np.stack(poses), np.stack(got_poses))
    np.testing.assert_array_equal(mp, got_map)
