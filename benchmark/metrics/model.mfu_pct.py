"""MinkUNet14's operations on the traced scans (counted from their sites by
benchmark/work/minkunet.py) over the traced wall time, as a share of one
H100's dense bf16 peak (%)."""

from benchmark import peaks


def read(r):
    ops = r.work.get("model_ops")
    if not ops or r.busy_s <= 0:
        return None
    return 100.0 * ops / r.window_s / peaks.BF16_FLOPS
