"""Masked evaluation metrics (counterpart of sps_tpu/utils/metrics.py).

MSE and R2 over scan points, and binary precision/recall/F1/accuracy/dIoU
at threshold eps, with the reference's 0-on-empty-denominator convention.
All results are 0-d tensors on the inputs' device (no host sync).
"""

from __future__ import annotations

import torch


def masked_mse(pred, target, mask):
    w = mask.to(pred.dtype)
    n = torch.clamp_min(w.sum(), 1.0)
    return (w * (pred - target) ** 2).sum() / n


def masked_r2(pred, target, mask):
    """R2 = 1 - SS_res / SS_tot (torchmetrics R2Score semantics)."""
    w = mask.to(pred.dtype)
    n = torch.clamp_min(w.sum(), 1.0)
    mean_t = (w * target).sum() / n
    ss_res = (w * (pred - target) ** 2).sum()
    ss_tot = torch.clamp_min((w * (target - mean_t) ** 2).sum(), 1e-12)
    return 1.0 - ss_res / ss_tot


def binary_at_threshold(scores, labels, mask, eps):
    """Binarize both at eps (>= eps -> 1 'unstable'); confusion counts."""
    pred = (scores >= eps) & mask
    gt = (labels >= eps) & mask
    tp = (pred & gt).sum()
    tn = (~pred & ~gt & mask).sum()
    fp = (pred & ~gt).sum()
    fn = (~pred & gt).sum()
    return tp, tn, fp, fn


def classification_metrics(scores, labels, mask, eps):
    """dict(precision, recall, f1, accuracy, dIoU) as 0-d f32 tensors."""
    tp, tn, fp, fn = (x.float() for x in binary_at_threshold(scores, labels, mask, eps))

    def safe(num, den):
        return torch.where(den > 0, num / torch.clamp_min(den, 1.0), torch.zeros_like(num))

    precision = safe(tp, tp + fp)
    recall = safe(tp, tp + fn)
    f1 = safe(2 * precision * recall, precision + recall)
    accuracy = safe(tp + tn, tp + tn + fp + fn)
    diou = safe(tp, tp + fn + fp)
    return {
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "accuracy": accuracy,
        "dIoU": diou,
    }
