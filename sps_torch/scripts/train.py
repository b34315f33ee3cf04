"""Train the SPS stability model (the CLI of scripts/train.py):

    python -m sps_torch.scripts.train -c config/config.yaml --data DIR \\
        [--log-dir ./tb_logs] [--ckpt-dir ./checkpoints] [--max-steps N] [--seed 0] \\
        [--resume] [--devices 1] [--device cpu]

Writes <ckpt-dir>/best.pt and <ckpt-dir>/last.pt (sps_torch/utils/checkpoint.py;
`python -m sps_torch.scripts.predict -w <ckpt-dir>/best.pt` evaluates one)
and <log-dir>/<EXPERIMENT.ID>.jsonl. Trains on the card unless --device cpu.
Data-parallel over N cards: `--devices N` spawns the ranks, or

    torchrun --standalone --nproc_per_node N -m sps_torch.scripts.train -c ... --devices N
"""

from __future__ import annotations

import argparse


def main(argv=None):
    from sps_torch import config as cfg_mod
    from sps_torch import train

    ap = argparse.ArgumentParser(description="Train the SPS stability model.")
    ap.add_argument("-c", "--config", default="./config/config.yaml",
                    help="path to the config file (.yaml)")
    ap.add_argument("--data", default=None, help="dataset root (defaults to $DATA)")
    ap.add_argument("--log-dir", default="./tb_logs")
    ap.add_argument("--ckpt-dir", default="./checkpoints")
    ap.add_argument("--max-steps", type=int, default=None, help="stop early (smoke runs)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume", action="store_true",
                    help="continue from <ckpt-dir>/last.pt (weights and optimizer state)")
    ap.add_argument("--devices", type=int, default=1,
                    help="data-parallel training over N cards (N CPU processes with "
                         "--device cpu): spawned here, or one rank a process under torchrun")
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' for the CPU")
    args = ap.parse_args(argv)
    cfg = cfg_mod.load(args.config, data_root=args.data)
    best = train.fit(cfg, log_dir=args.log_dir, ckpt_dir=args.ckpt_dir,
                     max_steps=args.max_steps, seed=args.seed, resume=args.resume,
                     devices=args.devices, device=args.device)
    print(f"best checkpoint: {best}")
    return best


if __name__ == "__main__":
    main()
