"""Shared set-up of the benchmark's own tests (run them with
`python -m pytest benchmark/tests -q -p no:randomly`): the repository's root
on the import path, the marker of the tests that need a CUDA card, and a
tiny cell on the CPU (a 12 m world, 8,192-point scans, capacities cut to
fit, float32) whose files sit in a temporary root as the harness finds
them by name."""

import json
import os
import shutil
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


TINY_TPU = dict(SCAN_POINTS=8192, SUBMAP_POINTS=8192, BRICKS=[2048, 1024, 512, 256, 128],
                ATLAS_EXTENT=[40, 40, 16], JOIN_EXTENT=[400, 400, 100], BF16=False, INT8=False)
TINY_WORLD = {"extent_m": 12.0, "n_rays": 600, "max_range_m": 10.0}


def tiny_root(tmp, **tpu) -> tuple:
    """(bench doc, root) of the tiny cell blt.stream: the real metric
    readers and limits, shortened traffic, a cut config."""
    root = os.path.join(tmp, "bench")
    shutil.copytree(os.path.join(BENCH, "metrics"), os.path.join(root, "metrics"))
    shutil.copytree(os.path.join(BENCH, "limits"), os.path.join(root, "limits"))
    os.makedirs(os.path.join(root, "traffic"))
    with open(os.path.join(BENCH, "traffic", "stream.json")) as f:
        tr = json.load(f)
    tr.update(distinct_scans=6, warmup_scans=2, trace_scans=3, sample_rebuilds=1,
              sample_reuses=2)
    with open(os.path.join(root, "traffic", "stream.json"), "w") as f:
        json.dump(tr, f)
    with open(os.path.join(BENCH, "configs", "sps_blt.json")) as f:
        cfg = json.load(f)
    cfg["TPU"].update(TINY_TPU, **tpu)
    cfg["world"] = TINY_WORLD
    with open(os.path.join(root, "tiny.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for c in bench["configs"]:
        c["file"] = os.path.join(root, "tiny.json")
    return bench, root


@pytest.fixture
def tiny(tmp_path):
    return tiny_root(str(tmp_path))
