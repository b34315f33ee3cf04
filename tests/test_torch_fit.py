"""sps_torch.train.fit on a tiny synthetic world on the CPU, MinkUNet14 at
full width. config_small's capacities are cut so that a step takes ~2 s
here: VOXEL_SIZE 0.4 (the world's 20 m fits an 8 x 8 x 2-brick atlas
window), SCAN_POINTS and SUBMAP_POINTS 4096 (the scans hold ~3.6k points),
BRICKS 128 a level (256 after the rounding of sps_config), the atlas
engine in halo mode (the port runs no other) and the dense join over
64 x 64 x 16 cells.

The data logic (batch order, tail padding, validation batches, the
resume's replay of an interrupted epoch, the host path) is checked with
train_step and eval_step replaced by recorders; one run trains for real:
an epoch, validation, `best` and `last`, two resumes, then `best` through
convert.load_weights and eval.predict_sequence."""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from sps_torch import config, train
from sps_torch import eval as ev
from sps_torch.convert import load_weights
from sps_torch.data import synthetic
from sps_torch.utils import checkpoint as ckpt
from sps_tpu import config as jconfig
from sps_tpu.data.blt import BLTDataModule as JBLTDataModule

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUT = dict(engine="atlas", conv_mode="halo", atlas_extent=(8, 8, 2), scan_points=4096,
           submap_points=4096, bricks=(128, 128, 128, 128, 128),
           voxels=(8192, 4096, 2048, 1024, 512), join_mode="dense", join_extent=(64, 64, 16))


def _world(root, per_seq):
    """Per sequence its scan count: train 20220420 + 20220601, val 20220608,
    test 20220629."""
    for seq, n in per_seq.items():
        synthetic.generate(root, sequences=(seq,), scans_per_seq=n, seed=0, extent=10.0,
                           n_rays=260, ground_points=4000, n_stable=8)
    return root


def _cfg(mod, root, **train_kw):
    cfg = mod.load(os.path.join(_ROOT, "config", "config_small.yaml"), data_root=root)
    return dataclasses.replace(cfg, voxel_size=0.4, tpu=dataclasses.replace(cfg.tpu, **CUT),
                               train=dataclasses.replace(cfg.train, **train_kw))


class Recorder:
    """Stands in for train_step / eval_step: records the batches as numpy."""

    def __init__(self):
        self.train, self.val = [], []

    def train_step(self, state, batch, map_points, rng=None, map_vm=None, *, cfg, augment):
        self.train.append({k: v.numpy().copy() for k, v in batch.items()})
        state.step += 1
        z = torch.zeros(())
        return {"loss": z, "r2": z, "overflow": z.bool(), "submap_overflow": z.int()}

    def eval_step(self, state, batch, map_points, map_vm=None, *, cfg):
        self.val.append({k: v.numpy().copy() for k, v in batch.items()})
        return {"loss": torch.tensor(0.1), "r2": torch.tensor(0.0)}


@pytest.fixture
def recorder(monkeypatch):
    rec = Recorder()
    monkeypatch.setattr(train, "train_step", rec.train_step)
    monkeypatch.setattr(train, "eval_step", rec.eval_step)
    return rec


def _same(a, b):
    return all(np.array_equal(a[k], b[k]) for k in ("xyz", "label", "valid"))


def test_batch_order_and_padding_match_sps_tpu(tmp_path, recorder, monkeypatch):
    """Epoch e visits the train split in sps_tpu's order (BLTDataModule.batches
    with seed + e; 5 scans: the tail batch padded with an empty sample);
    validation drops a ragged tail (3 val scans: one batch). The host path
    (a split over DEVICE_SPLIT_BYTES) gives the same batches."""
    root = _world(str(tmp_path / "w"), {"20220420": 3, "20220601": 2, "20220608": 3})
    cfg = _cfg(config, root, max_epoch=2)
    jdm = JBLTDataModule(_cfg(jconfig, root, max_epoch=2))
    want = [b for e in range(2) for b in jdm.batches(jdm.train, 2, True, seed=7 + e)]
    assert len(want) == 6 and not want[2]["valid"][1].any()
    train.fit(cfg, log_dir=str(tmp_path / "l"), ckpt_dir=str(tmp_path / "c"), seed=7,
              device="cpu")
    assert len(recorder.train) == 6 and all(map(_same, recorder.train, want))
    assert len(recorder.val) == 2  # one a validation
    vwant = next(jdm.batches(jdm.val, 2, False))
    assert all(_same(v, vwant) for v in recorder.val)
    device_path = recorder.train[:]
    recorder.train.clear()
    monkeypatch.setattr(train, "DEVICE_SPLIT_BYTES", 0)
    train.fit(cfg, log_dir=str(tmp_path / "l2"), ckpt_dir=str(tmp_path / "c2"), seed=7,
              device="cpu")
    assert len(recorder.train) == 6 and all(map(_same, recorder.train, device_path))


def test_small_val_split_is_padded(tmp_path, recorder):
    root = _world(str(tmp_path / "w"), {"20220420": 2, "20220601": 2, "20220608": 1})
    cfg = _cfg(config, root, max_epoch=1)
    train.fit(cfg, log_dir=str(tmp_path / "l"), ckpt_dir=str(tmp_path / "c"), device="cpu")
    (v,) = recorder.val
    assert v["valid"][0].any() and not v["valid"][1].any()


def test_resume_replays_an_interrupted_epoch(tmp_path, recorder):
    root = _world(str(tmp_path / "w"), {"20220420": 2, "20220601": 2, "20220608": 2})
    cfg = _cfg(config, root, max_epoch=3)
    kw = dict(log_dir=str(tmp_path / "l"), ckpt_dir=str(tmp_path / "c"), device="cpu")
    assert train.fit(cfg, max_steps=3, **kw).endswith("last.pt")  # epoch 1, batch 0
    first = [b["xyz"] for b in recorder.train]
    out = ckpt.restore(str(tmp_path / "c" / "last.pt"))
    assert (out["step"], out["epoch"], out["mid_epoch"]) == (3, 1, True)
    recorder.train.clear()
    train.fit(cfg, max_steps=5, resume=True, **kw)
    # Epoch 1 replays from its first batch.
    assert np.array_equal(recorder.train[0]["xyz"], first[2])
    out = ckpt.restore(str(tmp_path / "c" / "last.pt"))
    assert (out["step"], out["epoch"], out["mid_epoch"]) == (5, 1, True)


def test_resume_errors(tmp_path):
    root = _world(str(tmp_path / "w"), {"20220420": 2, "20220601": 2, "20220608": 1})
    cfg = _cfg(config, root)
    kw = dict(log_dir=str(tmp_path / "l"), ckpt_dir=str(tmp_path / "c"), device="cpu")
    with pytest.raises(FileNotFoundError, match="no last checkpoint"):
        train.fit(cfg, resume=True, **kw)
    model = train.create_state(cfg, 0, 1, "cpu").model
    ckpt.save(str(tmp_path / "c" / "last.pt"), model, cfg)  # not full: no optimizer state
    with pytest.raises(ValueError, match="no optimizer state"):
        train.fit(cfg, resume=True, **kw)
    # Data-parallel fit's contract (sps_tpu's): the batch divides over the
    # devices, and fewer devices than asked are an error.
    with pytest.raises(ValueError, match="not divisible by devices 3"):
        train.fit(dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, batch_size=2)),
                  devices=3, **kw)
    with pytest.raises(ValueError, match="available"):
        train.fit(dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, batch_size=1024)),
                  devices=1024, **kw)


def test_fit_resume_and_predict_from_best(tmp_path):
    """An epoch (2 steps) and a validation write best and last; resume to
    step 3 (epoch 1, interrupted), resume again to step 4 (epoch 1
    replays); the optimizer state carries over; best evaluates."""
    root = _world(str(tmp_path / "w"), {"20220420": 2, "20220601": 2, "20220608": 2,
                                        "20220629": 1})
    kw = dict(log_dir=str(tmp_path / "l"), ckpt_dir=str(tmp_path / "c"), device="cpu")
    best = train.fit(_cfg(config, root, max_epoch=1), **kw)
    assert best.endswith("best.pt") and os.path.isfile(best)
    out = ckpt.restore(str(tmp_path / "c" / "last.pt"))
    assert (out["step"], out["epoch"], out["mid_epoch"]) == (2, 0, False)
    assert np.isfinite(out["best_val"])
    cfg = _cfg(config, root, max_epoch=3)
    train.fit(cfg, max_steps=3, resume=True, **kw)
    shutil.copy(tmp_path / "c" / "last.pt", tmp_path / "step3.pt")
    train.fit(cfg, max_steps=4, resume=True, **kw)
    out = ckpt.restore(str(tmp_path / "c" / "last.pt"))
    assert (out["step"], out["epoch"], out["mid_epoch"]) == (4, 1, True)
    state = out["optimizer"]["state"]
    assert all(int(s["step"]) == 4 for s in state.values())
    assert all(float(s["exp_avg_sq"].abs().sum()) > 0 for s in state.values())
    assert out["scheduler"]["last_epoch"] == 4
    # The weights moved between step 3 and step 4.
    s3 = ckpt.restore(str(tmp_path / "step3.pt"))["model"]
    assert not torch.equal(s3["MinkUNet.final.kernel"], out["model"]["MinkUNet.final.kernel"])
    lines = open(tmp_path / "l" / "SMOKE.jsonl").read().splitlines()
    assert any('"val_loss"' in line for line in lines)

    sd = load_weights(best, cfg.sps_config(1))
    assert sd.keys() == ckpt.restore(best)["model"].keys()
    means = ev.predict_sequence(cfg, sd, device="cpu")
    for k in ev.METRICS:
        assert np.isfinite(means[k]), k
    assert 0 <= means["Loss"] <= 1


def test_dist_feature_trains_on_a_coarser_map(tmp_path, recorder, monkeypatch):
    """DIST_FEATURE: fit hands every step the registration map of the map
    points at 4x VOXEL_SIZE (sps_tpu's train.py: the distance LUT must
    resolve distances past DIST_CAP)."""
    root = _world(str(tmp_path / "w"), {"20220420": 2, "20220601": 2, "20220608": 1})
    cfg = dataclasses.replace(_cfg(config, root, max_epoch=1), dist_feature=True)
    seen = []
    real = recorder.train_step

    def step(state, batch, map_points, rng=None, map_vm=None, **kw):
        seen.append(map_vm)
        return real(state, batch, map_points, rng, map_vm, **kw)

    monkeypatch.setattr(train, "train_step", step)
    train.fit(cfg, log_dir=str(tmp_path / "l"), ckpt_dir=str(tmp_path / "c"), device="cpu")
    assert len(seen) == 2 and all(vm is seen[0] for vm in seen)
    assert seen[0].voxel_size == pytest.approx(4 * cfg.voxel_size) and seen[0].num_voxels > 0


def test_train_cli(tmp_path, capsys):
    """python -m sps_torch.scripts.train with the repo's flags, on the CPU."""
    from sps_torch.scripts import train as cli

    root = _world(str(tmp_path / "w"), {"20220420": 2, "20220601": 2, "20220608": 1})
    cfg_path = tmp_path / "small.yaml"
    text = open(os.path.join(_ROOT, "config", "config_small.yaml")).read()
    text = text.replace("ENGINE: gather", "ENGINE: atlas").replace(
        "ATLAS_EXTENT: [160, 160, 64]", "ATLAS_EXTENT: [8, 8, 2]").replace(
        "VOXEL_SIZE: 0.1", "VOXEL_SIZE: 0.4").replace(
        "SCAN_POINTS: 8192", "SCAN_POINTS: 4096").replace(
        "SUBMAP_POINTS: 8192", "SUBMAP_POINTS: 4096").replace(
        "BRICKS: [4096, 2048, 1024, 512, 512]", "BRICKS: [128, 128, 128, 128, 128]")
    text += "  JOIN_MODE: dense\n  JOIN_EXTENT: [64, 64, 16]\n"
    cfg_path.write_text(text)
    out = cli.main(["-c", str(cfg_path), "--data", root, "--log-dir", str(tmp_path / "l"),
                    "--ckpt-dir", str(tmp_path / "c"), "--max-steps", "1", "--seed", "3",
                    "--device", "cpu"])
    assert out.endswith("last.pt") and "best checkpoint" in capsys.readouterr().out
    assert ckpt.restore(out)["step"] == 1
