"""The halo assembly's gradient: the port's gather-transpose (brick.halo /
halo_z under autograd) against jax.vjp of sps_tpu.ops.brick.halo / halo_z
on the nbr27 tables of atlas levels (the port's atlas, bit-equal to
sps_tpu's: tests/test_torch_atlas.py), at pads 1 and 2; the asymmetric
fallback (fewer output bricks than input bricks: plain autograd through
the gathers, sps_tpu's _halo_impl autodiff); and a gradcheck in f64. Also
the halo conv's gradients (brick._conv3d_valid: the input gradient as a
forward conv) against autograd through F.conv3d.

Bricks past num_bricks hold zeros, as the model's masked features do. The
cotangent is zero on them too: their conv outputs are masked, so nothing
flows back into their halos in the model. (sps_tpu takes the centre of a
halo from the features themselves, the port through nbr27's centre row,
which is -1 there; the two agree on real bricks.) f32, sums of at most
eight terms in another order: rtol/atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sps_torch.ops import atlas as atl
from sps_torch.ops import brick as bk
from sps_tpu.ops import brick as jbk

TC = 3


@pytest.fixture(scope="module")
def levels():
    rng = np.random.default_rng(0)
    n = 900
    coords = torch.as_tensor(rng.integers(-22, 22, size=(n, 3)).astype(np.int32))
    t = torch.as_tensor(rng.integers(0, 2, size=n).astype(np.int32))
    grid, _ = atl.voxelize_bricks(coords, torch.zeros(n, dtype=torch.int32), t,
                                  torch.ones(n, dtype=torch.bool), num_time=2,
                                  brick_capacity=320, brick_side=8, extent=(1, 8, 8, 8))
    lvls = atl.build_levels(grid, num_levels=2, capacities=(320, 96))
    for lv in lvls:
        assert 0 < int(lv.grid.num_bricks) < lv.nbr27.shape[1]
    return lvls


def _inputs(lv, pad, folded, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    b, nb = lv.nbr27.shape[1], int(lv.grid.num_bricks)
    bs = lv.grid.occ.shape[1]
    x = rng.normal(size=(b, bs, bs, bs, TC)).astype(dtype)
    x[nb:] = 0
    h = bs + 2 * pad
    g = rng.normal(size=(b, h, h, h, TC)).astype(dtype)
    g[nb:] = 0
    if folded:
        x, g = x.reshape(b, bs, bs, bs * TC), g.reshape(b, h, h, h * TC)
    return x, g


def _port_grad(x, g, nbr27, pad, folded):
    xt = torch.from_numpy(x).requires_grad_(True)
    y = bk.halo_z(xt, nbr27, pad, TC) if folded else bk.halo(xt, nbr27, pad)
    y.backward(torch.from_numpy(g))
    return y.detach().numpy(), xt.grad.numpy(), type(y.grad_fn).__name__


def _jax_grad(x, g, nbr27, pad, folded):
    nb = jnp.asarray(nbr27.numpy())
    # Fewer output bricks than inputs: sps_tpu takes the outputs' centres
    # as `center` (the port reads them through nbr27's centre row).
    bout = nbr27.shape[1]

    def f(a):
        center = None if bout == a.shape[0] else a[:bout]
        return (jbk.halo_z(a, nb, pad, TC, center=center) if folded else
                jbk.halo(a, nb, pad, center=center))

    f = jax.jit(f)
    y, vjp = jax.vjp(f, jnp.asarray(x))
    return np.asarray(y), np.asarray(vjp(jnp.asarray(g))[0])


@pytest.mark.parametrize("folded", [False, True], ids=["halo", "halo_z"])
@pytest.mark.parametrize("pad", [1, 2])
@pytest.mark.parametrize("level", [0, 1])
def test_halo_gradient_matches_sps_tpu(levels, level, pad, folded):
    lv = levels[level]
    x, g = _inputs(lv, pad, folded, seed=10 * level + pad)
    y, dx, fn = _port_grad(x, g, lv.nbr27, pad, folded)
    assert fn == "_SymmetricHaloBackward"  # the gather-transpose, not autograd's scatter
    y_j, dx_j = _jax_grad(x, g, lv.nbr27, pad, folded)
    np.testing.assert_array_equal(y, y_j)
    np.testing.assert_allclose(dx, dx_j, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("folded", [False, True], ids=["halo", "halo_z"])
def test_transpose_equals_autograd_of_the_assembly(levels, folded):
    """Any cotangent, phantom rows included: the gather-transpose is the
    exact adjoint of the port's assembly."""
    lv = levels[0]
    x, _ = _inputs(lv, 1, folded, seed=5)
    rng = np.random.default_rng(6)
    g = torch.from_numpy(rng.normal(size=bk.halo_z(torch.from_numpy(x), lv.nbr27, 1, TC).shape
                                    if folded else
                                    bk.halo(torch.from_numpy(x), lv.nbr27, 1).shape)
                         .astype(np.float32))
    _, dx, _ = _port_grad(x, g.numpy(), lv.nbr27, 1, folded)
    xt = torch.from_numpy(x).requires_grad_(True)
    bk._halo_assemble(xt, lv.nbr27, 1, TC if folded else 1).backward(g)
    np.testing.assert_allclose(dx, xt.grad.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("folded", [False, True], ids=["halo", "halo_z"])
def test_asymmetric_tables_fall_back_to_autograd(levels, folded):
    """Fewer output bricks than input bricks (sps_tpu's dispatch: the
    symmetric VJP only when feats.shape[0] == nbr27.shape[1])."""
    lv = levels[0]
    nbr = lv.nbr27[:, : int(lv.grid.num_bricks) // 2].contiguous()
    x, g = _inputs(lv, 1, folded, seed=7)
    g = g[: nbr.shape[1]]
    _, dx, fn = _port_grad(x, g, nbr, 1, folded)
    assert fn != "_SymmetricHaloBackward"
    _, dx_j = _jax_grad(x, g, nbr, 1, folded)
    np.testing.assert_allclose(dx, dx_j, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("folded", [False, True], ids=["halo", "halo_z"])
def test_halo_gradcheck_f64(folded):
    """torch.autograd.gradcheck of the custom backward in f64 on a toy grid
    of 2^3 bricks, one channel (pad 2 = bs: a line sits in up to nine
    halo columns of each dz)."""
    rng = np.random.default_rng(1)
    n = 12
    coords = torch.as_tensor(rng.integers(-3, 3, size=(n, 3)).astype(np.int32))
    grid, _ = atl.voxelize_bricks(coords, torch.zeros(n, dtype=torch.int32),
                                  torch.zeros(n, dtype=torch.int32), torch.ones(n, dtype=torch.bool),
                                  num_time=1, brick_capacity=12, brick_side=2,
                                  extent=(1, 3, 3, 3))
    nbr = atl.build_levels(grid, num_levels=1, capacities=(12,))[0].nbr27
    b = nbr.shape[1]
    assert int(grid.num_bricks) < b
    x = torch.randn((b, 2, 2, 2, 1), dtype=torch.float64)
    x[int(grid.num_bricks):] = 0
    if folded:
        x = x.reshape(b, 2, 2, 2)
    x.requires_grad_(True)
    for pad in (1, 2):
        f = ((lambda a: bk.halo_z(a, nbr, pad, 1)) if folded else
             (lambda a: bk.halo(a, nbr, pad)))
        assert torch.autograd.gradcheck(f, (x,), eps=1e-6, atol=1e-8)


@pytest.mark.parametrize("k", [3, 5])
def test_halo_conv3d_gradient(k):
    """The halo conv's input gradient as a forward conv (the FULL correlation
    with the flipped, channel-transposed kernel) and its weight gradient
    against autograd through F.conv3d, f64: equal to 1e-12; and gradcheck."""
    rng = np.random.default_rng(k)
    x = torch.from_numpy(rng.normal(size=(3, 6 + k, 6 + k, 6 + k, 4)))
    w = torch.from_numpy(rng.normal(size=(k, k, k, 4, 5)))
    g = torch.from_numpy(rng.normal(size=(3, 7, 7, 7, 5)))
    grads = []
    for fn in (bk._conv3d_valid, bk._conv3d_fwd):
        xt, wt = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        y = fn(xt, wt)
        y.backward(g)
        grads.append((type(y.grad_fn).__name__, xt.grad, wt.grad))
    assert grads[0][0] == "_Conv3dValidBackward" and grads[1][0] != grads[0][0]
    torch.testing.assert_close(grads[0][1], grads[1][1], rtol=0, atol=1e-12)
    torch.testing.assert_close(grads[0][2], grads[1][2], rtol=0, atol=1e-12)
    small = (x[:1, : k + 1, : k + 1, : k + 1, :2].clone().requires_grad_(True),
             w[..., :2, :2].clone().requires_grad_(True))
    assert torch.autograd.gradcheck(bk._Conv3dValid.apply, small)
