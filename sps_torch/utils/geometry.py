"""SE(3) helpers (counterpart of sps_tpu/utils/geometry.py)."""

from __future__ import annotations

import torch


def transform_points(points: torch.Tensor, tr: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 homogeneous transform to (N, 3) points (row vectors)."""
    xyz = points[..., :3]
    out = xyz @ tr[:3, :3].T + tr[:3, 3]
    w = xyz @ tr[3, :3] + tr[3, 3]
    return out / w[..., None]
