"""Point batches, static capacities and device selection (counterpart of
sps_tpu/structs.py)."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The port's entry points run on the card unless the caller asks for
    the CPU: device=None means CUDA, and raises when no card is present."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain versions"
            )
        return torch.device("cuda")
    return torch.device(device)


class PointBatch(NamedTuple):
    """A padded, fixed-capacity batch of 4D points."""

    xyz: torch.Tensor  # (N, 3) float32, map frame
    batch: torch.Tensor  # (N,) int32
    t: torch.Tensor  # (N,) int32 time slot (SPS: scan=1, map=0)
    label: torch.Tensor  # (N,) float32 stability label in [0, 1]
    valid: torch.Tensor  # (N,) bool
    # Per-point distance to the map (the dist_feature input), computed before
    # any augmentation; None when the feature is off.
    dist: torch.Tensor | None = None  # (N,) float32

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]


def pad_point_batch(xyz: np.ndarray, batch: np.ndarray, t: np.ndarray,
                    label: np.ndarray, capacity: int, device=None) -> PointBatch:
    """Host-side: pad arrays to the static point capacity."""
    if len(xyz) > capacity:
        raise ValueError(f"point count {len(xyz)} exceeds capacity {capacity}")
    n = len(xyz)
    dev = resolve_device(device)

    def pad(a, dtype):
        out = np.zeros((capacity,) + a.shape[1:], dtype)
        out[:n] = a[:n]
        return torch.as_tensor(out, device=dev)

    valid = np.zeros(capacity, bool)
    valid[:n] = True
    return PointBatch(
        xyz=pad(xyz, np.float32),
        batch=pad(batch, np.int32),
        t=pad(t, np.int32),
        label=pad(label, np.float32),
        valid=torch.as_tensor(valid, device=dev),
    )


@dataclasses.dataclass(frozen=True)
class Capacities:
    """Static shape budget; overflow is reported as data, not a shape change.

    voxels: per-level row capacities; bricks: per-level brick capacities."""

    points: int = 1 << 18
    voxels: tuple = (1 << 17, 1 << 15, 1 << 13, 1 << 11, 1 << 9)
    bricks: tuple = (1 << 14, 1 << 13, 1 << 12, 1 << 11, 1 << 10)
