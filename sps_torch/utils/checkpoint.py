"""The trainer's checkpoints (counterpart of sps_tpu/utils/checkpoint.py).

The port's own format, one file written with torch.save: the model's
state_dict (parameters and BN running statistics), `step`, the config as a
dict and, for a resumable (`full`) save, the optimizer's and the LR
schedule's state, `epoch`, `best_val` and `mid_epoch` (the save
interrupted an epoch). A JSON copy of the config sits beside it
(`<path>.config.json`), as sps_tpu's does. sps_tpu's orbax checkpoints are
not read here; scripts/export_torch_assets.py exports them to npz
(sps_torch.convert.load_npz).
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch

FORMAT = "sps_torch.checkpoint/1"


def _config_dict(cfg) -> dict:
    """A config dataclass as nested dicts of plain values (dtypes as text)."""
    def enc(o):
        if dataclasses.is_dataclass(o):
            return {f.name: enc(getattr(o, f.name)) for f in dataclasses.fields(o)}
        if isinstance(o, (tuple, list)):
            return [enc(x) for x in o]
        if isinstance(o, torch.dtype):
            return str(o)
        return o

    return enc(cfg)


def save(path: str, model, cfg=None, *, step: int = 0, optimizer=None, scheduler=None,
         epoch: int | None = None, full: bool = False, best_val: float | None = None,
         mid_epoch: bool = False) -> None:
    """Write the checkpoint at `path` (replaced whole: written to a
    temporary file, then renamed). full=True adds the optimizer and
    schedule state and the counters that --resume needs."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    item = {"format": FORMAT, "model": model.state_dict(), "step": int(step)}
    if cfg is not None:
        item["config"] = _config_dict(cfg)
    if full:
        item.update(optimizer=optimizer.state_dict(), scheduler=scheduler.state_dict(),
                    epoch=-1 if epoch is None else int(epoch),
                    best_val=float("inf") if best_val is None else float(best_val),
                    mid_epoch=bool(mid_epoch))
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(item, tmp)
    os.replace(tmp, path)
    if cfg is not None:
        with open(path + ".config.json", "w") as f:
            json.dump(item["config"], f, indent=2)


def restore(path: str, map_location="cpu") -> dict:
    """The checkpoint's dict (tensors only are unpickled: weights_only)."""
    item = torch.load(os.path.abspath(path), map_location=map_location, weights_only=True)
    if not (isinstance(item, dict) and item.get("format") == FORMAT):
        raise ValueError(f"{path} is not a checkpoint of sps_torch's trainer")
    return item
