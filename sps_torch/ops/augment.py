"""Point-cloud augmentation as one 3x3 matrix (counterpart of
sps_tpu/ops/augment.py).

The reference's four transforms, applied jointly to scan and submap during
training: a random yaw, a small roll/pitch/yaw perturbation (Rz @ Ry @ Rx,
sigma 0.2 rad clipped at 0.5), random x/y flips and an anisotropic scale
U(0.8, 1.2). Points are row vectors, p' = p @ M. The composition
(`augmentation_matrix_from`) is apart from the draw (`draw`, from an
explicit torch.Generator), so that tests can hold the composition against
sps_tpu's on JAX's own draws.
"""

from __future__ import annotations

import math

import torch

ANGLE_SIGMA, ANGLE_CLIP = 0.2, 0.5  # rad: the rpy perturbation
SCALE_LOW, SCALE_HIGH = 0.8, 1.2


def _matrix(rows) -> torch.Tensor:
    return torch.stack([torch.stack(r) for r in rows])


def _rot_z(a):
    c, s, z, o = torch.cos(a), torch.sin(a), torch.zeros_like(a), torch.ones_like(a)
    return _matrix([[c, -s, z], [s, c, z], [z, z, o]])


def _rot_x(a):
    c, s, z, o = torch.cos(a), torch.sin(a), torch.zeros_like(a), torch.ones_like(a)
    return _matrix([[o, z, z], [z, c, -s], [z, s, c]])


def _rot_y(a):
    c, s, z, o = torch.cos(a), torch.sin(a), torch.zeros_like(a), torch.ones_like(a)
    return _matrix([[c, z, s], [z, o, z], [-s, z, c]])


def augmentation_matrix_from(yaw: torch.Tensor, ang: torch.Tensor, flips: torch.Tensor,
                             scales: torch.Tensor) -> torch.Tensor:
    """The composite matrix from its draws: yaw (), ang (3,) the clipped
    (roll, pitch, yaw) perturbation, flips (2,) bool for x and y, scales
    (3,). yaw -> rpy perturbation (Rz @ Ry @ Rx) -> flips -> scale."""
    m = _rot_z(yaw)
    m = m @ (_rot_z(ang[2]) @ _rot_y(ang[1]) @ _rot_x(ang[0]))
    one = torch.ones((), dtype=m.dtype, device=m.device)
    f = torch.stack([torch.where(flips[0], -one, one), torch.where(flips[1], -one, one), one])
    return m * f[None, :] * scales[None, :]


def draw(generator: torch.Generator):
    """(yaw, ang, flips, scales) drawn from `generator`, on its device."""
    dev = generator.device
    yaw = torch.rand((), generator=generator, device=dev) * (2 * math.pi)
    ang = torch.clamp(ANGLE_SIGMA * torch.randn(3, generator=generator, device=dev),
                      -ANGLE_CLIP, ANGLE_CLIP)
    flips = torch.rand(2, generator=generator, device=dev) > 0.5
    scales = SCALE_LOW + (SCALE_HIGH - SCALE_LOW) * torch.rand(3, generator=generator,
                                                                device=dev)
    return yaw, ang, flips, scales


def augmentation_matrix(generator: torch.Generator) -> torch.Tensor:
    """One composite 3x3 f32 matrix drawn from `generator`."""
    return augmentation_matrix_from(*draw(generator))
