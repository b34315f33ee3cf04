"""Augmentation: the port's composition (ops.augment.augmentation_matrix_from)
on JAX's own draws, reproduced here from the same key as
sps_tpu.ops.augment.augmentation_matrix draws them, against that function,
within 1e-6 (f32 rotations and products, composed in the same order); the
draw's determinism under a torch.Generator; and pipeline.assemble_batch,
which applies one matrix per sample to its scan and submap after the
distance feature."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sps_torch import config, pipeline
from sps_torch import register as reg
from sps_torch.ops import augment as aug
from sps_tpu.ops import augment as jaug

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_draws(key):
    """sps_tpu's draws, in its order: yaw, the clipped rpy perturbation,
    the flips, the scales (ops/augment.py:augmentation_matrix)."""
    k1, k2, k3, k4, _ = jax.random.split(key, 5)
    yaw = jax.random.uniform(k1, (), minval=0.0, maxval=2 * jnp.pi)
    ang = jnp.clip(0.2 * jax.random.normal(k2, (3,)), -0.5, 0.5)
    flips = jax.random.uniform(k3, (2,)) > 0.5
    scales = jax.random.uniform(k4, (3,), minval=0.8, maxval=1.2)
    return [torch.from_numpy(np.array(a)) for a in (yaw, ang, flips, scales)]


@pytest.mark.parametrize("seed", range(8))
def test_composition_matches_sps_tpu(seed):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jaug.augmentation_matrix(key))
    got = aug.augmentation_matrix_from(*_jax_draws(key))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_draw_is_deterministic_and_in_range():
    mats = [aug.augmentation_matrix(torch.Generator().manual_seed(s)) for s in (7, 7, 8)]
    assert torch.equal(mats[0], mats[1]) and not torch.equal(mats[0], mats[2])
    g = torch.Generator().manual_seed(0)
    for _ in range(50):
        yaw, ang, flips, scales = aug.draw(g)
        assert 0 <= float(yaw) < 2 * np.pi and float(ang.abs().max()) <= 0.5
        assert bool(((scales >= 0.8) & (scales < 1.2)).all()) and flips.dtype == torch.bool
        m = aug.augmentation_matrix_from(yaw, ang, flips, scales)
        # A rotation times flips and scales: |det| is the scales' product,
        # its sign the flips' parity.
        det = float(torch.linalg.det(m.double()))
        sign = (-1) ** int(flips.sum())
        np.testing.assert_allclose(det, sign * float(scales.double().prod()), rtol=1e-5)


def test_assemble_batch_augments_each_sample_after_the_distance_feature():
    cfg = config.load(os.path.join(_ROOT, "config", "config.yaml"))
    cfg = dataclasses.replace(cfg, tpu=dataclasses.replace(
        cfg.tpu, submap_points=64, join_extent=(64, 64, 32)))
    rng = np.random.default_rng(0)
    mp = torch.from_numpy(rng.uniform(-2, 2, (400, 3)).astype(np.float32))
    xyz = torch.from_numpy(rng.uniform(-2, 2, (3, 50, 3)).astype(np.float32))
    label = torch.from_numpy(rng.random((3, 50)).astype(np.float32))
    valid = torch.from_numpy(rng.random((3, 50)) < 0.8)
    vm = reg.build_voxel_map(mp.numpy(), 0.4, device="cpu")
    plain, _ = pipeline.assemble_batch(xyz, label, valid, mp, cfg, map_vm=vm)
    got, _ = pipeline.assemble_batch(xyz, label, valid, mp, cfg, torch.Generator().manual_seed(3),
                                     map_vm=vm)
    g = torch.Generator().manual_seed(3)
    mats = [aug.augmentation_matrix(g) for _ in range(3)]
    assert not torch.equal(mats[0], mats[1])
    n = plain.xyz.shape[0] // 3
    for b in range(3):
        rows = slice(b * n, (b + 1) * n)
        torch.testing.assert_close(got.xyz[rows], plain.xyz[rows] @ mats[b], rtol=1e-6,
                                   atol=1e-6)
    # The distance feature is that of the original geometry; the rest is unchanged.
    assert torch.equal(got.dist, plain.dist) and bool((plain.dist[plain.valid] < 1.0).any())
    for f in ("batch", "t", "label", "valid"):
        assert torch.equal(getattr(got, f), getattr(plain, f)), f
