"""Port of the z-band conv: the plain versions in sps_torch.ops.zband_conv
(what a CPU tensor computes, and what the CUDA kernels are held against on
the card) against sps_tpu.ops.pallas_conv, both its CPU branch and the
Pallas kernels in interpret mode, on the same seeded inputs. f32 at
rtol 1e-5 / atol 1e-5 (the same f32 sums in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sps_tpu.ops import brick as jbk
from sps_tpu.ops import pallas_conv as pc
from sps_torch.ops import brick as tbk
from sps_torch.ops import zband_conv as zc

TOL = dict(rtol=1e-5, atol=1e-5)


def _case(k=3, bs=4, tcin=2, tcout=3, b=8, seed=0):
    rng = np.random.default_rng(seed)
    h = bs + k - 1
    hz = rng.standard_normal((b, h, h, h * tcin)).astype(np.float32)
    w = rng.standard_normal((k, k, k, tcin, tcout)).astype(np.float32)
    return hz, w


def _epilogue(b, bs, tb, seed=1):
    rng = np.random.default_rng(seed)
    scale = rng.uniform(0.5, 2.0, tb).astype(np.float32)
    bias = rng.standard_normal(tb).astype(np.float32)
    occ = rng.integers(0, 2, (b, bs, bs, tb)).astype(np.float32)
    res = rng.standard_normal((b, bs, bs, tb)).astype(np.float32) * occ
    return scale, bias, occ, res


@pytest.mark.parametrize("k,bs,tcin,tcout,b", [
    (3, 4, 2, 3, 8), (3, 8, 2, 2, 8), (5, 4, 1, 2, 8), (3, 4, 2, 2, 6),
])
def test_zband_conv_matches_pallas(k, bs, tcin, tcout, b):
    hz, w = _case(k, bs, tcin, tcout, b)
    wz_j = jbk.pack_zband_kernel(jnp.asarray(w), bs, k // 2)
    wz_t = tbk.pack_zband_kernel(torch.from_numpy(w), bs, k // 2)
    np.testing.assert_array_equal(wz_t.numpy(), np.asarray(wz_j))
    got = zc.zband_conv(torch.from_numpy(hz), wz_t, k, bs)
    assert zc.LAUNCHES == {"zband_conv": 0, "zband_conv_fused": 0}
    want = pc.zband_conv(jnp.asarray(hz), wz_j, k, bs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want_i = pc.zband_conv(jnp.asarray(hz), wz_j, k, bs, 2 if b % 2 == 0 else 1, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_i), **TOL)


@pytest.mark.parametrize("k,bs,tcin,tcout,b,with_res,relu", [
    (3, 4, 2, 2, 4, True, True), (3, 4, 2, 2, 4, False, False),
    (5, 4, 1, 2, 6, True, True), (3, 8, 2, 2, 6, False, True),
])
def test_zband_conv_fused_matches_pallas(k, bs, tcin, tcout, b, with_res, relu):
    hz, w = _case(k, bs, tcin, tcout, b)
    wz = np.array(jbk.pack_zband_kernel(jnp.asarray(w), bs, k // 2))
    tb = wz.shape[-1]
    scale, bias, occ, res = _epilogue(b, bs, tb)
    res = res if with_res else None
    t = torch.from_numpy
    got = zc.zband_conv_fused(t(hz), t(wz), t(scale), t(bias), t(occ),
                              None if res is None else t(res), k=k, bs=bs, relu=relu)
    j = jnp.asarray
    args = (j(hz), j(wz), j(scale), j(bias), j(occ), None if res is None else j(res))
    want = pc.zband_conv_fused(*args, k=k, bs=bs, relu=relu)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want_i = pc.zband_conv_fused(*args, k=k, bs=bs, relu=relu, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_i), **TOL)


def test_wrapper_refuses_unsupported_input():
    """A CUDA-only launcher on a non-CPU, non-CUDA tensor raises; the plain
    version runs only for CPU tensors."""
    hz, w = _case()
    wz = tbk.pack_zband_kernel(torch.from_numpy(w), 4, 1)
    with pytest.raises(ValueError):
        zc.zband_conv(torch.from_numpy(hz).to("meta"), wz.to("meta"), 3, 4)
