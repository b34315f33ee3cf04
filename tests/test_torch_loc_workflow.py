"""The port's localization-evidence workflow (sps_torch/scripts/
{calibrate_threshold,loc_experiment,loc_calibrate_ate,loc_pipeline}.py)
against the JAX scripts it ports, on the CPU, no JAX program:

  * the epsilon sweep equals the loop of scripts/calibrate_threshold.py (and
    stage C of scripts/loc_pipeline.py), run from the script's own text on
    the same seeded scores: F1 is 2PR / max(P + R, 1e-9), not
    utils.metrics.classification_metrics' (whose max(P + R, 1) stays);
  * epsilon_robustness equals scripts/loc_calibrate_ate.py's on random
    sweeps (that module loads without JAX);
  * summary.md's rows equal those of scripts/loc_experiment.py's summary
    code, run from its text on a fixed set of result rows;
  * the CLIs on a tiny dataset (three scans of the baseline train pin's
    world written as the val and test sequences) with config_loc_small.yaml
    cut to 256 bricks a level in f32: calibrate_threshold's scan spread and
    JSON, loc_experiment's results.jsonl and summary.md ({raw, oracle,
    sps@0.5});
  * loc_calibrate_ate and loc_pipeline on the same dataset (~35 s):
    loc_calibrate_ate on a two-point grid writes calibration.json (the
    sweep, the ATE-optimal epsilon, its robustness window, the protocol)
    and the sidecar's threshold, and runs the table at that epsilon, a
    filter whose weights are missing failing alone (logged and skipped: the
    workflow's isolation, as in scripts/loc_calibrate_ate.py); loc_pipeline
    with --skip-train and --skip-baselines runs stages B-E: the max-F1
    epsilon of the val sequence into calibration.json and the sidecar, its
    StreamingFilter reused by the table at that epsilon."""

import importlib.util
import json
import os
import re
import sys
import textwrap

import numpy as np
import pytest
import torch

from sps_torch import config as tcfg_mod
from sps_torch.models import spsnet
from sps_torch.scripts import calibrate_threshold as cal
from sps_torch.scripts import loc_calibrate_ate as ate
from sps_torch.scripts import loc_experiment as lexp
from sps_torch.scripts import loc_pipeline as lpipe
from sps_torch.utils import checkpoint, metrics

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_ROOT, "scripts"))
import export_torch_assets as exp  # noqa: E402

SEQS = ("20220608", "20220629", "20220629_clean")


def _script_text(name):
    with open(os.path.join(_ROOT, "scripts", name)) as f:
        return f.read()


def _block(text, start, end):
    """The JAX script's source from the line starting `start` up to (not
    including) the line starting `end`, dedented."""
    i = text.index(start)
    return textwrap.dedent(text[i:text.index(end, i)])


def _jax_sweep(s, lbl, script="calibrate_threshold.py"):
    """The script's sweep, run from its text."""
    text = _script_text(script)
    if script == "calibrate_threshold.py":
        code = _block(text, "    best = None\n", "    print(json.dumps(best))")
        ns = {"np": np, "s": s, "l": lbl, "seq": "S"}
        exec(code, ns)
        return ns["best"]
    code = _block(text, "        best_row, curve = None, []\n",
                  "        with open(os.path.join(ckpt_out, \"calibration.json\")")
    ns = {"np": np, "s": s, "lbl": lbl, "seq": "S"}
    exec(code, ns)
    return ns["best_row"]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("script", ["calibrate_threshold.py", "loc_pipeline.py"])
def test_sweep_equals_the_jax_scripts(seed, script):
    rng = np.random.default_rng(seed)
    lbl = rng.random(5000) < 0.3
    s = np.clip(rng.normal(0.35 + 0.4 * lbl, 0.2), 0, 1).astype(np.float32)
    got = cal.sweep_epsilon(s, lbl, sequence="S")
    want = _jax_sweep(s, lbl, script)
    assert list(got) == list(want)  # the same keys in the same order
    assert got == want
    assert got["epsilon"] in [round(float(e), 3) for e in cal.EPSILON_GRID]
    assert 0 <= got["f1"] <= 1 and len(got["curve"]) == 9


def test_f1_is_not_classification_metrics():
    """P 0.25, R 0.2: the sweep's F1 is 2PR / (P + R) = 0.2222, while
    classification_metrics keeps sps_tpu's max(P + R, 1) (0.1)."""
    lbl = np.zeros(40, bool)
    lbl[:20] = True
    s = np.full(40, 0.01, np.float32)
    s[:4] = 0.99  # 4 TP
    s[20:32] = 0.99  # 12 FP
    row = cal.sweep_epsilon(s, lbl)
    assert row["precision"] == 0.25 and row["recall"] == 0.2 and row["f1"] == 0.2222
    m = metrics.classification_metrics(torch.as_tensor(s), torch.as_tensor(lbl.astype(np.float32)),
                                       torch.ones(40, dtype=torch.bool), 0.5)
    assert abs(float(m["f1"]) - 0.1) < 1e-6


def _jax_ate_module():
    spec = importlib.util.spec_from_file_location(
        "jax_loc_calibrate_ate", os.path.join(_ROOT, "scripts", "loc_calibrate_ate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed", range(6))
def test_epsilon_robustness_equals_sps_tpus(seed):
    jmod = _jax_ate_module()
    rng = np.random.default_rng(seed)
    grid = sorted(rng.choice(np.round(np.linspace(0.1, 0.99, 30), 3), 7, replace=False))
    sweep = [{"epsilon": float(e), "ate_rmse": round(float(rng.gamma(2.0, 0.02)), 4)}
             for e in grid]
    rng.shuffle(sweep)
    best = min(sweep, key=lambda r: r["ate_rmse"])["epsilon"]
    for eps in (best, float(grid[0]), 0.5):  # the deployed value, another, one off the grid
        for blowup in (1.5, 2.0):
            assert ate.epsilon_robustness(sweep, eps, blowup) == jmod.epsilon_robustness(
                sweep, eps, blowup)


def _rows():
    rows = []
    rng = np.random.default_rng(4)
    for run in range(3):
        for seq in ("20220629", "20220629_clean"):
            for flt in ("sps", "raw", "sps@0.5"):
                rows.append({"run": run, "seq": seq, "filter": flt, "prior": "odom",
                             "refine": True, "ate_rmse": float(rng.gamma(2, 0.03)),
                             "kept_frac_mean": float(rng.uniform(0.4, 1.0)),
                             "init_noise": 0.05, "icp_iters": 12, "weights": "w.npz",
                             "baseline_weights": "random-init"})
    rows.append({**rows[0], "prior": "cv", "ate_rmse": 0.2})  # a second protocol, one run
    rows.append({**rows[1], "refine": False, "init_noise": 0.0})
    return rows


def test_summary_rows_equal_the_jax_scripts():
    rows = _rows()
    code = _block(_script_text("loc_experiment.py"), "    def _vals(key, default=None):",
                  "    with open(os.path.join(out, \"summary.md\"), \"w\") as f:")
    ns = {"np": np, "allrows": rows}
    exec(code, ns)
    got = lexp.summary_lines(rows)
    assert got == ns["lines"]
    assert len(got) == 4 + 6 + 2
    assert "| runs |" in got[2] and "| 3 |" in got[4]
    assert lexp.parse_filter("sps@0.5") == ("sps", 0.5) and lexp.parse_filter("raw") == ("raw",
                                                                                        None)


# ---------------------------------------------------------------- the CLIs
SCANS = 3  # a sequence: the first of exp.baseline_train_inputs' six


def _write_dataset(root):
    """exp.baseline_train_inputs' first SCANS scans as each of SEQS, and its
    map."""
    scans, poses, mp = exp.baseline_train_inputs()
    scans, poses = scans[:SCANS], poses[:SCANS]
    os.makedirs(os.path.join(root, "maps"), exist_ok=True)
    np.save(os.path.join(root, "maps", "base_map.asc.npy"),
            np.concatenate([mp, np.zeros((len(mp), 1), np.float32)], 1))
    for seq in SEQS:
        sdir = os.path.join(root, "sequence", seq)
        os.makedirs(os.path.join(sdir, "scans"))
        os.makedirs(os.path.join(sdir, "poses"))
        np.savetxt(os.path.join(sdir, "map_transform"), np.eye(4), delimiter=",")
        for i, (sc, p) in enumerate(zip(scans, poses)):
            np.save(os.path.join(sdir, "scans", f"{i:06d}.npy"), sc)
            np.savetxt(os.path.join(sdir, "poses", f"{i:06d}.txt"), p, delimiter=",")
    return scans


CUT = {"SCAN_POINTS": "1024", "SUBMAP_POINTS": "4096", "CELL_CAPACITY": "8192",
       "VOXELS": "[8192, 4096, 2048, 1024, 512]", "BRICKS": "[256, 256, 256, 256, 256]",
       "BF16": "false"}


def _write_config(path):
    """config_loc_small.yaml with CUT's capacities, f32."""
    text = _script_text(os.path.join("..", "config", "config_loc_small.yaml"))
    for key, val in CUT.items():
        text, n = re.subn(rf"(\n\s*{key}:).*", rf"\g<1> {val}", text)
        assert n == 1, key
    with open(path, "w") as f:
        f.write(text)
    return path


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("workflow")
    data = str(root / "data")
    scans = _write_dataset(data)
    cfg_path = _write_config(str(root / "config.yaml"))
    cfg = tcfg_mod.load(cfg_path, data_root=data)
    weights = str(root / "ckpt" / "best.pt")
    model = spsnet.SPSModel(cfg.sps_config(1))
    model.load_state_dict(spsnet.init_state_dict(cfg.sps_config(1), seed=0))
    checkpoint.save(weights, model, cfg)
    return dict(root=root, data=data, cfg_path=cfg_path, cfg=cfg, weights=weights, scans=scans)


class _Fake:
    """A stand-in filter: scores 0.9 on label-1 points, 0.1 elsewhere."""

    def __init__(self):
        self.calls = []

    def __call__(self, sx, sv, sl, pose):
        self.calls.append(int(sv.sum()))
        return torch.as_tensor(np.where(sl > 0.5, 0.9, 0.1).astype(np.float32)), None, None


def test_calibrate_spreads_the_scans(world):
    fake = _Fake()
    best, filt = cal.calibrate(world["cfg"], None, "20220608", max_scans=3, filt=fake)
    assert filt is fake and len(fake.calls) == 3
    n = [len(world["scans"][i]) for i in np.linspace(0, SCANS - 1, 3).astype(int)]
    assert fake.calls == n and best["points"] == sum(n)
    assert best["f1"] == 1.0 and best["sequence"] == "20220608"
    assert 0.1 <= best["epsilon"] < 0.9


def test_calibrate_threshold_cli(world, capsys):
    best = cal.main(["-c", world["cfg_path"], "-w", world["weights"], "--data", world["data"],
                     "--max-scans", "2", "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == best
    assert best["epsilon"] in [round(float(e), 3) for e in cal.EPSILON_GRID]
    assert 0 <= best["f1"] <= 1 and best["sequence"] == "20220608"


def test_loc_experiment_cli(world):
    out = str(world["root"] / "exp")
    lines = lexp.main(["-c", world["cfg_path"], "-w", world["weights"], "--data",
                       world["data"], "-seq", "20220629", "--filters", "raw,oracle,sps@0.5",
                       "--out", out, "--fresh", "--device", "cpu"])
    with open(os.path.join(out, "results.jsonl")) as f:
        rows = [json.loads(ln) for ln in f]
    assert [r["filter"] for r in rows] == ["raw", "oracle", "sps@0.5"]
    assert rows[2]["epsilon"] == 0.5 and all(np.isfinite(r["ate_rmse"]) for r in rows)
    with open(os.path.join(out, "summary.md")) as f:
        assert f.read().splitlines() == lines
    assert len(lines) == 4 + 3 and "| odom | y | 20220629 | sps@0.5 |" in lines[-1]


@pytest.mark.limit(600)  # 166 s on a worker of -n 6 (8 CPUs)
def test_loc_calibrate_ate_and_pipeline(world, tmp_path):
    """loc_calibrate_ate on a two-point grid, then loc_pipeline with
    --skip-train and --skip-baselines: calibration.json, the sidecar's
    threshold, the table; a filter whose weights are missing fails alone."""
    ckdir = tmp_path / "ck"
    ckdir.mkdir()
    w = str(ckdir / "best.pt")
    for suffix in ("", ".config.json"):
        with open(world["weights"] + suffix, "rb") as src, open(w + suffix, "wb") as dst:
            dst.write(src.read())
    out = str(tmp_path / "ate")
    res = ate.main(["-c", world["cfg_path"], "--data", world["data"], "-w", w,
                    "--baselines", str(tmp_path / "none"), "--grid", "0.5,0.9",
                    "--runs", "1", "--filters", "sps,raw,mos4d", "--out", out,
                    "--device", "cpu"])
    with open(ckdir / "calibration.json") as f:
        calj = json.load(f)
    assert calj["epsilon_ate"] in (0.5, 0.9) and len(calj["ate_sweep"]) == 2
    assert calj["epsilon_robustness"] == ate.epsilon_robustness(calj["ate_sweep"],
                                                                calj["epsilon_ate"])
    assert calj["ate_sweep"][0]["per_seq"].keys() == {"20220608"}  # no <val>_clean here
    with open(w + ".config.json") as f:
        assert json.load(f)["threshold"] == calj["epsilon_ate"]
    # mos4d has no weights under --baselines: logged and skipped, the rest ran.
    assert sorted({(r["seq"], r["filter"]) for r in res["results"]}) == [
        ("20220629", "raw"), ("20220629", "sps"), ("20220629_clean", "raw"),
        ("20220629_clean", "sps")]
    sps = [r for r in res["results"] if r["filter"] == "sps"]
    assert all(r["epsilon"] == calj["epsilon_ate"] for r in sps)

    pout = str(tmp_path / "pipe")
    got = lpipe.main(["-c", world["cfg_path"], "--data", world["data"], "--ckpt-out",
                      str(ckdir), "--skip-train", "--skip-baselines", "--runs", "1",
                      "--filters", "sps,raw", "--out", pout, "--device", "cpu"])
    with open(ckdir / "calibration.json") as f:
        c = json.load(f)
    assert c["epsilon"] == got["epsilon"] and c["sequence"] == "20220608"
    with open(w + ".config.json") as f:
        assert json.load(f)["threshold"] == got["epsilon"]
    with open(os.path.join(pout, "summary.md")) as f:
        table = f.read().splitlines()
    assert table[0] == "| sequence | filter | ATE-RMSE (m) | kept |" and len(table) == 2 + 4
    assert all(r["epsilon"] == got["epsilon"] for r in got["results"] if r["filter"] == "sps")
