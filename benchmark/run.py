"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration (configs/<config>.json), its traffic mix
(traffic/<traffic>.json), its limits (limits/<cell>.json) and the
per-layer metrics' readers (metrics/<metric>.py) are found by the names in
BENCHMARK.json; the traffic's "kind" picks the driver in kinds/. The last
line of standard output is one JSON object: correct, attempted, failed,
metrics (the cell's end-to-end metrics, or with --trace 1 its per-layer
metrics), device, with --trace 1 the breakdown, and last the numbers
compared with the reference beside their limits, which also end standard
error. Without a CUDA card holding the chips the cell asks for, or with
JAX or the JAX package loaded once the window has closed, it prints no
result and exits with a code other than 0.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import common  # noqa: E402


def _cell_metrics(bench: dict, cell: str, key: str) -> list:
    return [m for m in bench[key] if "workloads" not in m or cell in m["workloads"]]


def run_cell(bench: dict, workload: str, seed: int, seconds: float, trace: bool, device: str,
             t0: float, root: str = common.HERE) -> dict:
    """Drive the cell and build the result object (not yet printed)."""
    ctx = common.context(bench, workload, seed, seconds, trace, device, t0, root)
    kind = importlib.import_module(f"benchmark.kinds.{ctx.traffic['kind']}")
    out = kind.run(ctx)
    if trace:
        reading = out["reading"]
        metrics = {}
        for m in _cell_metrics(bench, workload, "per_layer"):
            value = common.metric_reader(m["name"], root)(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["metrics"][m["name"]], "unit": m["unit"]}
                   for m in _cell_metrics(bench, workload, "end_to_end")}
    import torch

    on_card = device.startswith("cuda")
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": ctx.cell["chips"], "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": all(c["ok"] for c in out["checks"]), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    if trace:
        r = out["reading"]
        dev["busy_s"], dev["window_s"] = r.busy_s, r.window_s
        result["breakdown"] = {"device_ops": r.device_ops(), "idle_gaps": r.idle_gaps}
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in out["checks"]}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    common.set_cache_dirs()
    bench = common.load_json(common.ROOT, "BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"the cell needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 3
    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                      T0)
    found = common.forbidden_modules()
    if found:
        print(f"loaded after the window: {', '.join(found)}", file=sys.stderr)
        return 4
    print(f"card: {common.card_line()}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
