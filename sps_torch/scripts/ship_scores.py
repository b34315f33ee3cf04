"""Compare the shipping path's scores of two or more checkouts, bit for bit, on the card.

    python3 -m sps_torch.scripts.ship_scores ROOT [ROOT ...]

Each ROOT is a checkout of this repository (the working tree, or an
earlier commit unpacked with `git archive REV sps_torch chip_smoke.py
config | tar -x -C build/parent`). For each, a fresh process started in
that ROOT imports its own chip_smoke.py and sps_torch and drives the
shipping path as chip_smoke.py's phase 6 does: StreamingFilter at
config/config.yaml as shipped (CONV_MODE halo, INT8, HEAD_FOLD, bf16),
weights from spsnet.init_state_dict(seed=0), chip_smoke.py's 10 BLT-scale
scans. It prints each run's kernel launches and per-scan latencies and
then, for each ROOT after the first, whether its scores equal the first
ROOT's bit for bit (and the largest difference where not). Exits 1 when
they differ.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

RUN = """
import json, sys
import numpy as np
sys.path.insert(0, ".")
import chip_smoke as cs
from sps_torch import config
from sps_torch.models import spsnet
shipped = config.load("config/config.yaml")
scfg = shipped.sps_config(1)
stable, scans, labels, valids = cs.blt_scale_scans(10, shipped.tpu.scan_points)
_, run = cs.drive(shipped, spsnet.init_state_dict(scfg, seed=0), stable, (scans, valids, labels))
np.savez(sys.argv[1], *run["scores"])
print(json.dumps({"launches": run["launches"], "lat_ms": run["lat"]}))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", type=Path, nargs="+", help="checkouts of this repository")
    args = ap.parse_args(argv)
    scores = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, root in enumerate(args.roots):
            out = Path(tmp) / f"scores{i}.npz"
            r = subprocess.run([sys.executable, "-c", RUN, str(out)], cwd=root, text=True,
                               capture_output=True)
            if r.returncode != 0:
                print(r.stdout + r.stderr, file=sys.stderr)
                raise SystemExit(f"ship_scores: the run in {root} failed")
            print(f"{root}: {r.stdout.strip().splitlines()[-1]}", flush=True)
            with np.load(out) as z:
                scores.append([z[k] for k in sorted(z.files, key=lambda k: int(k.split("_")[1]))])
    same = True
    for root, s in zip(args.roots[1:], scores[1:]):
        eq = all(a.shape == b.shape and np.array_equal(a.view(np.uint32), b.view(np.uint32))
                 for a, b in zip(scores[0], s))
        d = max(float(np.abs(a - b).max()) for a, b in zip(scores[0], s))
        print(json.dumps({"root": str(root), "against": str(args.roots[0]),
                          "bit_equal": eq, "max_abs_diff": d}), flush=True)
        same = same and eq
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
