"""The harness: the result line's keys, the files found by name, the card
and import checks, and a directory without the program."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import common, run

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(tiny, trace):
    bench, root = tiny
    r = run.run_cell(bench, "blt.stream", 2**31 + 5, 0.5, trace, "cpu", 0.0, root)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"} | (
        {"busy_s", "window_s"} if trace else set())
    if trace:
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        assert len(r["breakdown"]["idle_gaps"]) <= 10
    else:
        assert set(r["metrics"]) == {"filter_scans_per_s", "filter_ms.p95", "setup_s"}
    assert r["correct"] is True and r["attempted"] >= 1
    assert set(r["checks"]) == {"score_gap_mean", "keep_not_score", "keep_off_far",
                                "miss_not_half"}
    json.dumps(r)


def test_new_files_found_by_name(tiny):
    """A new configuration, traffic mix, limits and metric reader are added
    as files and entries only; the harness finds each by its name."""
    bench, root = tiny
    with open(os.path.join(root, "tiny.json")) as f:
        cfg = json.load(f)
    cfg["FILTER"]["THRESHOLD"] = 0.5
    with open(os.path.join(root, "tiny_b.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(root, "traffic", "stream.json")) as f:
        tr = json.load(f)
    tr["step_m"] = 0.5
    with open(os.path.join(root, "traffic", "stream_far.json"), "w") as f:
        json.dump(tr, f)
    shutil.copy(os.path.join(root, "limits", "blt.stream.json"),
                os.path.join(root, "limits", "b.far.json"))
    with open(os.path.join(root, "metrics", "engine.reuse_share.py"), "w") as f:
        f.write("def read(r):\n    g = r.ranges.get('sps.reuse')\n"
                "    return None if not g else 100.0 * g['count'] / r.steps\n")
    bench["configs"].append({"name": "b", "source": "x", "file": os.path.join(root, "tiny_b.json"),
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "b.far", "config": "b", "traffic": "stream_far",
                               "chips": 1, "why": "x"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "blt.stream" in m["workloads"]:
            m["workloads"].append("b.far")
    bench["per_layer"].append({"name": "engine.reuse_share", "unit": "%", "better": "lower",
                               "source": "program_span", "layer": "engine",
                               "moves": "filter_scans_per_s", "workloads": ["b.far"]})
    r = run.run_cell(bench, "b.far", 9, 0.5, True, "cpu", 0.0, root)
    assert r["metrics"]["engine.reuse_share"]["value"] == pytest.approx(100 * 2 / 3)


def test_forbidden_names_compare_whole_top_level_names():
    assert common.forbidden_modules(["sps_torch.ops", "jaxtyping", "flaxx", "numpy"]) == []
    assert common.forbidden_modules(["jax.numpy", "sps_tpu.ops", "orbax.checkpoint", "flax",
                                     "jaxlib"]) == ["flax", "jax", "jaxlib", "orbax", "sps_tpu"]


def test_a_run_loads_nothing_of_jax(tmp_path):
    """A tiny CPU run of the harness in a fresh process, then the names of
    every loaded module against JAX's and the JAX package's."""
    code = (
        "import sys, json; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "from conftest import tiny_root\n"
        "from benchmark import common, run\n"
        "bench, root = tiny_root(%r)\n"
        "run.run_cell(bench, 'blt.stream', 3, 0.2, True, 'cpu', 0.0, root)\n"
        "print(json.dumps(common.forbidden_modules()))\n"
    ) % (ROOT, HERE, str(tmp_path))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=str(tmp_path), timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_no_card_no_result(capsys):
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "blt.stream", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_without_the_program_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "blt.stream",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.card
def test_cell_on_the_card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "blt.stream",
                          "--seed", "12345", "--seconds", "3", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True
