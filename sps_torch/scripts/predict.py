"""Evaluate a checkpoint on one sequence (the CLI of scripts/predict.py):

    python -m sps_torch.scripts.predict -w sps_torch/assets/ckpt_loc_movers.npz \\
        -c config/config_loc_movers.yaml -seq 20220629 --data DIR [--save-vis] [--device cpu]

-w takes an exported checkpoint .npz (sps_torch.convert.load_npz), a
checkpoint of the port's trainer (sps_torch.scripts.train's best.pt) or a
reference .ckpt (sps_torch.convert.load_me_ckpt). Prints the table of
mean Loss/R2/dIoU/Precision/Recall/F1 over the sequence's scans.
"""

from __future__ import annotations

import argparse
import dataclasses


def main(argv=None):
    from sps_torch import config as cfg_mod
    from sps_torch import eval as eval_mod
    from sps_torch.convert import load_weights

    ap = argparse.ArgumentParser(description="Evaluate a checkpoint on a sequence.")
    ap.add_argument("-w", "--weights", required=True,
                    help="an exported checkpoint .npz, a trainer checkpoint (best.pt) "
                         "or a reference .ckpt")
    ap.add_argument("-seq", "--sequence", default=None,
                    help="evaluate this sequence instead of the config's test split")
    ap.add_argument("-c", "--config", default="./config/config.yaml")
    ap.add_argument("--data", default=None, help="dataset root (defaults to $DATA)")
    ap.add_argument("--save-vis", action="store_true")
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' for the CPU")
    args = ap.parse_args(argv)
    cfg = cfg_mod.load(args.config, data_root=args.data)
    if args.sequence:
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, test=(args.sequence,)))
    if len(cfg.data.test) != 1:
        raise SystemExit("Only one test SEQ is allowed at a time!")
    print("Test seq:", list(cfg.data.test))
    sd = load_weights(args.weights, cfg.sps_config(1))
    return eval_mod.predict_sequence(cfg, sd, save_vis=args.save_vis, device=args.device)


if __name__ == "__main__":
    main()
