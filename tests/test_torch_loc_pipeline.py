"""The port's loc_calibrate_ate and loc_pipeline CLIs (sps_torch/scripts/)
on the CPU, on test_torch_loc_workflow.py's tiny dataset and cut config
(no JAX program, ~35 s): loc_calibrate_ate on a two-point grid writes
calibration.json (the sweep, the ATE-optimal epsilon, its robustness
window, the protocol) and the sidecar's threshold, and runs the table at
that epsilon, a filter whose weights are missing failing alone (logged and
skipped: the workflow's isolation, as in scripts/loc_calibrate_ate.py);
loc_pipeline with --skip-train and --skip-baselines runs stages B-E: the
max-F1 epsilon of the val sequence into calibration.json and the sidecar,
its StreamingFilter reused by the table at that epsilon."""

import json
import os

from test_torch_loc_workflow import world  # noqa: F401  (the module's fixture)

from sps_torch.scripts import loc_calibrate_ate as ate
from sps_torch.scripts import loc_pipeline as lpipe


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
