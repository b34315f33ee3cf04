"""Generate a synthetic BLT-layout dataset, for tests and benchmarks where
the BLT / NCLT downloads are unavailable (the port of
scripts/make_synthetic_data.py, with its option names and defaults):

    python -m sps_torch.scripts.make_synthetic_data --root DIR [--scans-per-seq 12] \\
        [--seed 0] [--n-rays 400] [--ground-points 22000] [--dense ...]

Writes the tree that sps_torch.data.synthetic.generate (or, with --dense,
generate_dense) writes; the bytes equal sps_tpu's generator's.
"""

from __future__ import annotations

import argparse


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Generate a synthetic BLT-layout dataset.")
    ap.add_argument("--root", type=str, required=True)
    ap.add_argument("--scans-per-seq", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-rays", type=int, default=400,
                    help="scan density; 400 -> ~6k pts/scan (fits config_small), use ~8000 "
                         "for BLT-scale ~120k pts (config.yaml)")
    ap.add_argument("--ground-points", type=int, default=22000)
    ap.add_argument("--dense", action="store_true",
                    help="dense-world generator (surface-sampled map and scans; use for "
                         "localization experiments - see generate_dense)")
    ap.add_argument("--map-density", type=float, default=260.0)
    ap.add_argument("--scan-density", type=float, default=28.0)
    ap.add_argument("--extent", type=float, default=22.0,
                    help="dense-world half-extent in m (world spans +-extent)")
    ap.add_argument("--n-stable", type=int, default=28, help="dense-world stable structure count")
    ap.add_argument("--clutter-boxes", type=int, default=14)
    ap.add_argument("--clutter-scale", type=float, default=1.6)
    ap.add_argument("--growth-boxes", type=int, default=0,
                    help="per-seq inflated copies of mapped structures (walls offset <1 m "
                         "from real walls; biases ICP - the change mode SPS filtering targets)")
    ap.add_argument("--mover-boxes", type=int, default=0,
                    help="per-seq boxes translating 0.25-0.8 m between scans (actors; the "
                         "motion signal MOS4D detects)")
    ap.add_argument("--clean-sequences", type=str, default="",
                    help="csv sequence names generated with zero clutter (unchanged-world "
                         "control)")
    ap.add_argument("--sequences", type=str, default="",
                    help="csv sequence names (default: the 4 BLT-style names)")
    return ap


def main(argv=None):
    from sps_torch.data import synthetic

    a = parser().parse_args(argv)
    if a.dense:
        kw = {}
        if a.sequences:
            kw["sequences"] = tuple(s.strip() for s in a.sequences.split(","))
        synthetic.generate_dense(
            a.root,
            scans_per_seq=a.scans_per_seq,
            seed=a.seed,
            map_density=a.map_density,
            scan_density=a.scan_density,
            extent=a.extent,
            n_stable=a.n_stable,
            clutter_boxes=a.clutter_boxes,
            clutter_scale=a.clutter_scale,
            growth_boxes=a.growth_boxes,
            mover_boxes=a.mover_boxes,
            clean_sequences=tuple(s.strip() for s in a.clean_sequences.split(",") if s.strip()),
            **kw,
        )
    else:
        synthetic.generate(a.root, scans_per_seq=a.scans_per_seq, seed=a.seed, n_rays=a.n_rays,
                           ground_points=a.ground_points)
    print(f"synthetic dataset written to {a.root}")


if __name__ == "__main__":
    main()
