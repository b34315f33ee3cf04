"""What every kind of cell shares: the run's context, the device, the limits,
the result line and the check that nothing of JAX was loaded."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "sps_tpu")


@dataclasses.dataclass
class Context:
    bench: dict  # BENCHMARK.json
    cell: dict  # its entry of "workloads"
    config: dict  # configs/<config>.json
    config_path: str
    traffic: dict  # traffic/<traffic>.json
    limits: dict  # limits/<cell>.json: compared number -> limit
    seed: int
    seconds: float
    trace: bool
    device: str
    t0: float  # perf_counter at process start


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def context(bench: dict, workload: str, seed: int, seconds: float, trace: bool, device: str,
            t0: float, root: str = HERE) -> Context:
    """The cell's files, found by the names in BENCHMARK.json."""
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config_path = os.path.join(ROOT, cfg_entry["file"])
    return Context(bench=bench, cell=cell, config=load_json(config_path),
                   config_path=config_path,
                   traffic=load_json(root, "traffic", f"{cell['traffic']}.json"),
                   limits=load_json(root, "limits", f"{workload}.json"), seed=seed,
                   seconds=seconds, trace=trace, device=device, t0=t0)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: str = HERE):
    """benchmark/metrics/<name>.py's read(reading)."""
    return load_module(os.path.join(root, "metrics", f"{name}.py"),
                       "benchmark_metric_" + name.replace(".", "_")).read


def forbidden_modules(names=None) -> list:
    """Loaded modules (or `names`) whose top-level name is JAX's, its
    libraries' or the JAX package's, compared whole: sps_torch is not
    sps_tpu."""
    return sorted({m.split(".")[0] for m in (sys.modules if names is None else names)}
                  & set(FORBIDDEN))


def check(name: str, value: float, limit: float) -> dict:
    ok = math.isfinite(value) and value <= limit
    return {"name": name, "value": value, "limit": limit, "ok": ok}


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def set_cache_dirs() -> None:
    """Every build and kernel cache of a run at a fixed path in the checkout
    (the program builds its kernels into build/torch_ext there)."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def sync(device: str) -> None:
    if str(device).startswith("cuda"):
        import torch

        torch.cuda.synchronize()


class F32:
    """Float32 matmuls for the reference (TF32 off), restored after."""

    def __enter__(self):
        import torch

        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        import torch

        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


def log_marks(t0: float, marks: list) -> None:
    """Set-up phases on standard error: seconds since process start, then
    each phase's own seconds."""
    parts = [f"start {marks[0][1] - t0:.3f}"]
    parts += [f"{name} {t - prev:.3f}" for (name, t), (_, prev) in zip(marks[1:], marks)]
    print("setup s: " + ", ".join(parts), file=sys.stderr)
