"""Sequence evaluation: per-scan Loss/R2/dIoU/Precision/Recall/F1
(counterpart of sps_tpu/eval.py).

Batch size 1: each test scan is joined with its submap (pipeline.
assemble_batch), scored through the model's PointBatch entry, and its
metrics taken over the scan's points, binarized at the config's threshold;
the means are printed as a table. Optionally writes per-scan prediction
.npy files. Runs on the card unless device="cpu" is passed. Profiler
ranges "sps.assemble" (the join and the batch) and "sps.model" label a
step's work in a torch.profiler trace.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch.profiler import record_function

from sps_torch import pipeline
from sps_torch import register as reg
from sps_torch.config import Config
from sps_torch.data.blt import BLTDataModule
from sps_torch.models.spsnet import SPSModel
from sps_torch.structs import resolve_device
from sps_torch.utils.metrics import classification_metrics, masked_mse, masked_r2

METRICS = ("Loss", "R2", "dIoU", "Precision", "Recall", "F1")
_NAMES = {"dIoU": "dIoU", "precision": "Precision", "recall": "Recall", "f1": "F1"}


def predict_step(model: SPSModel, batch: dict, map_points, map_vm=None, *, cfg: Config):
    """Score one scan (batch size 1): returns (scores over the whole point
    batch, the scan-point mask, metrics as 0-d tensors). The metrics are
    METRICS, "overflow" (a capacity overflowed) and "submap_overflow" (map
    points past SUBMAP_POINTS, left out of the submap)."""
    with record_function("sps.assemble"):
        pb, aux = pipeline.assemble_batch(batch["xyz"], batch["label"], batch["valid"],
                                          map_points, cfg, map_vm=map_vm)
    with record_function("sps.model"):
        scores, maux = model(pb)
    scan_mask = pb.valid & (pb.t == pipeline.SCAN_T)
    cls = classification_metrics(scores, pb.label, scan_mask, cfg.threshold)
    metrics = {
        "Loss": masked_mse(scores, pb.label, scan_mask),
        "R2": masked_r2(scores, pb.label, scan_mask),
        **{name: cls[k] for k, name in _NAMES.items()},
        "overflow": maux["overflow"].any(),
        "submap_overflow": aux["submap_overflow"],
    }
    return scores, scan_mask, metrics


def predict_sequence(cfg: Config, state_dict: dict, save_vis: bool = False,
                     device=None) -> dict[str, float]:
    """Run the test split; returns the mean metrics and prints the table."""
    dev = resolve_device(device)
    model = SPSModel(cfg.sps_config(batch_size=1))
    model.load_state_dict(state_dict, strict=True)
    model.to(dev).eval()
    data = BLTDataModule(cfg, test=True)
    map_points = torch.as_tensor(data.map_points, device=dev)
    map_vm = (reg.build_voxel_map(data.map_points, 4 * cfg.voxel_size, device=dev)
              if cfg.dist_feature else None)
    acc: dict[str, list[float]] = {}
    for batch in data.batches(data.test, 1, shuffle=False):
        hb = {k: torch.as_tensor(v, device=dev) for k, v in batch.items() if k != "indices"}
        with torch.inference_mode():
            scores, scan_mask, m = predict_step(model, hb, map_points, map_vm, cfg=cfg)
        for k, v in m.items():
            if k == "overflow":
                if bool(v):
                    print("WARNING: capacity overflow on scan", batch["indices"])
                continue
            acc.setdefault(k, []).append(float(v))
        if save_vis:
            _save_vis(cfg, batch, scores.float().cpu().numpy())
    means = {k: float(np.mean(v)) for k, v in acc.items()}
    print("\n########## Inference Metrics ##########")
    for name in METRICS:
        fill = "." * (12 - len(name))
        print(f"{name} {fill} {means[name]:.3f}")
    return means


def _save_vis(cfg: Config, batch, scores: np.ndarray):
    """predictions/<seq>/scans/<i>_0.npy: the scan's valid points as
    [x, y, z, label, score] float32 rows."""
    seq = cfg.data.test[0]
    s_path = os.path.join(cfg.data.root, "predictions", seq, "scans")
    os.makedirs(s_path, exist_ok=True)
    ns = cfg.tpu.scan_points
    valid = batch["valid"][0]
    pts = batch["xyz"][0][valid]
    gt = batch["label"][0][valid]
    hat = scores[:ns][valid]
    idx = int(batch["indices"][0])
    np.save(os.path.join(s_path, f"{idx}_0.npy"),
            np.column_stack([pts, gt, hat]).astype(np.float32))
