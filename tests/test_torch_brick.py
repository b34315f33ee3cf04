"""Port of the brick ops: sps_torch.ops.brick against sps_tpu.ops.brick on
the same seeded features and the same atlas topology tables (built by
sps_tpu and handed over as numpy). f32 at rtol 1e-5 / atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sps_tpu.ops import atlas as jatl
from sps_tpu.ops import brick as jbk
from sps_tpu.ops import sparse_conv as jsc
from sps_torch.ops import brick as tbk
from sps_torch.ops import sparse_conv as tsc

T = 2
BCAP = 128
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module", params=[4, 8], ids=["bs4", "bs8"])
def levels(request):
    """Two-level atlas pyramid (numpy tables) over coords with negatives."""
    bs = request.param
    rng = np.random.default_rng(bs)
    n = 150
    coords = rng.integers(-8, 8, (n, 3)).astype(np.int32)
    grid, _ = jax.jit(jatl.voxelize_bricks, static_argnames=(
        "num_time", "brick_capacity", "brick_side", "extent"))(
        jnp.asarray(coords), jnp.asarray(rng.integers(0, 2, n), jnp.int32),
        jnp.asarray(rng.integers(0, T, n), jnp.int32), jnp.ones(n, bool),
        num_time=T, brick_capacity=BCAP, brick_side=bs, extent=(2, 8, 8, 8),
    )
    lv = jax.jit(jatl.build_levels, static_argnames=("num_levels", "capacities"))(
        grid, num_levels=2, capacities=(BCAP, BCAP))
    assert not bool(grid.overflow)

    def np_level(level):
        return {
            "occ": np.asarray(level.grid.occ, np.float32),
            "nbr27": np.asarray(level.nbr27),
            "parent": None if level.parent is None else np.asarray(level.parent),
            "oct": None if level.oct is None else np.asarray(level.oct),
            "child": None if level.child is None else np.asarray(level.child),
        }

    return bs, [np_level(x) for x in lv]


def _feats(rng, occ, c):
    """Masked (B, bs, bs, bs, T*c) features (phantom slots exactly zero)."""
    f = rng.standard_normal(occ.shape + (c,)).astype(np.float32) * occ[..., None]
    return f.reshape(occ.shape[:4] + (T * c,))


@pytest.mark.parametrize("pad", [1, 2])
def test_halo_and_halo_z_match(levels, pad):
    bs, lv = levels
    rng = np.random.default_rng(pad)
    f = _feats(rng, lv[0]["occ"], 3)
    nbr = lv[0]["nbr27"]
    want = jax.jit(jbk.halo, static_argnums=2)(jnp.asarray(f), jnp.asarray(nbr), pad)
    got = tbk.halo(_t(f), _t(nbr), pad)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    fz = f.reshape(BCAP, bs, bs, -1)
    want_z = jax.jit(jbk.halo_z, static_argnums=(2, 3))(
        jnp.asarray(fz), jnp.asarray(nbr), pad, T * 3)
    got_z = tbk.halo_z(_t(fz), _t(nbr), pad, T * 3)
    np.testing.assert_array_equal(got_z.numpy(), np.asarray(want_z))


@pytest.mark.parametrize("k,kt", [(3, 3), (5, 1)])
def test_brick_conv_zband_and_halo_match(levels, k, kt):
    bs, lv = levels
    rng = np.random.default_rng(k)
    cin, cout = 2, 3
    occ = lv[0]["occ"]
    f = _feats(rng, occ, cin)
    w = (rng.standard_normal((k**3, kt, cin, cout)) * 0.3).astype(np.float32)
    wd_j = jbk.pack_dense_kernel(jnp.asarray(w), T)
    wd_t = tbk.pack_dense_kernel(_t(w), T)
    np.testing.assert_array_equal(wd_t.numpy(), np.asarray(wd_j))
    nbr = lv[0]["nbr27"]

    # halo mode: materialised halo + one VALID 3-D conv
    want = jax.jit(jbk.brick_conv, static_argnums=4)(
        jnp.asarray(f), jnp.asarray(nbr), wd_j, jnp.asarray(occ), "halo")
    got = tbk.brick_conv(_t(f), _t(nbr), wd_t, _t(occ))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    # zband: z folded into channels, one 2-D conv (the zband_conv kernel)
    fz = f.reshape(BCAP, bs, bs, -1)
    occz = occ.reshape(BCAP, bs, bs, -1)
    want_z = jax.jit(jbk.brick_conv_zband)(
        jnp.asarray(fz), jnp.asarray(nbr), wd_j, jnp.asarray(occz))
    got_z = tbk.brick_conv_zband(_t(fz), _t(nbr), wd_t, _t(occz))
    np.testing.assert_allclose(got_z.numpy(), np.asarray(want_z), **TOL)

    # fused epilogue (the zband_conv_fused kernel)
    scale = rng.uniform(0.5, 2.0, cout).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    occ_rep = np.repeat(occz, cout, axis=-1)
    res = rng.standard_normal(occ_rep.shape).astype(np.float32) * occ_rep
    want_f = jax.jit(jbk.brick_conv_zband_fused, static_argnames="num_time")(
        jnp.asarray(fz), jnp.asarray(nbr), wd_j, jnp.asarray(scale), jnp.asarray(bias),
        jnp.asarray(occ_rep), jnp.asarray(res), num_time=T)
    got_f = tbk.brick_conv_zband_fused(
        _t(fz), _t(nbr), wd_t, _t(scale), _t(bias), _t(occ_rep), _t(res), num_time=T)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), **TOL)


def test_brick_conv_down_up_match(levels):
    bs, lv = levels
    rng = np.random.default_rng(7)
    cin, cout = 3, 4
    w = (rng.standard_normal((8, 1, cin, cout)) * 0.3).astype(np.float32)
    wp_j = jsc.pack_time_toeplitz(jnp.asarray(w), T)
    wp_t = tsc.pack_time_toeplitz(_t(w), T)
    np.testing.assert_array_equal(wp_t.numpy(), np.asarray(wp_j))
    fine, coarse = lv

    f = _feats(rng, fine["occ"], cin)
    want = jax.jit(jbk.brick_conv_down)(jnp.asarray(f), jnp.asarray(coarse["child"]), wp_j,
                               jnp.asarray(coarse["occ"]))
    got = tbk.brick_conv_down(_t(f), _t(coarse["child"]), wp_t, _t(coarse["occ"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    cf = _feats(rng, coarse["occ"], cin)
    want = jax.jit(jbk.brick_conv_up)(jnp.asarray(cf), jnp.asarray(fine["parent"]),
                             jnp.asarray(fine["oct"]), wp_j, jnp.asarray(fine["occ"]))
    got = tbk.brick_conv_up(_t(cf), _t(fine["parent"]), _t(fine["oct"]), wp_t,
                            _t(fine["occ"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_brick_conv_up_from_rows_matches(levels):
    bs, lv = levels
    rng = np.random.default_rng(9)
    cin, cout, v = 3, 2, 50
    hs = bs // 2
    w = (rng.standard_normal((8, 1, cin, cout)) * 0.3).astype(np.float32)
    wp = np.asarray(jsc.pack_time_toeplitz(jnp.asarray(w), T))
    rows = rng.standard_normal((v, T * cin)).astype(np.float32)
    parent_rows = rng.integers(-1, v, (BCAP, hs, hs, hs)).astype(np.int32)
    occ = lv[0]["occ"]
    want = jax.jit(jbk.brick_conv_up_from_rows)(jnp.asarray(rows), jnp.asarray(parent_rows),
                                       jnp.asarray(wp), jnp.asarray(occ))
    got = tbk.brick_conv_up_from_rows(_t(rows), _t(parent_rows), _t(wp), _t(occ))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
