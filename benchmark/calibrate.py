"""The readings that a cell's limits are set from.

    python3 benchmark/calibrate.py --workload blt.stream --seconds 3 --seeds 1 2 3 ...

For each seed, in one process, at the cell's own size: the cell's set-up
and a short window of the program at the cell's own load, its sampled calls
compared with the reference (the program's readings), and the same calls
computed by the control, the reference one precision below the
configuration's (fp8 for bfloat16, int4 for the int8 convs), compared
alike (the control's readings). One JSON line a seed; the benchmark's own
runs never run this.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from benchmark import common  # noqa: E402
from benchmark.kinds import stream  # noqa: E402

LOOSE = {"score_gap_mean": float("inf")}


def control_samples(st, samples):
    cfg = st.cfg
    levels = tuple(range(cfg.tpu.row_from)) if cfg.tpu.int8 else ()
    out = []
    for k, _, _ in samples:
        sc, c = st.ref.scores(k, lower=True, int8_levels=levels)
        out.append((k, c, (c <= cfg.threshold) & sc.valid))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    common.set_cache_dirs()
    bench = common.load_json(common.ROOT, "BENCHMARK.json")
    for seed in args.seeds:
        t0 = time.perf_counter()
        ctx = common.context(bench, args.workload, seed, args.seconds, False, args.device, t0)
        st = stream.Stream(ctx)
        win = st.window(args.seconds)
        st.free()
        row = {"seed": seed, "calls": win["calls"], "samples": [k for k, _, _ in win["samples"]]}
        for side, samples in (("program", win["samples"]),
                              ("control", control_samples(st, win["samples"]))):
            extra: dict = {}
            checks = st.ref.compare(samples, LOOSE, extra)
            row[side] = {**{c["name"]: c["value"] for c in checks}, **extra}
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        del st
        if args.device.startswith("cuda"):
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
