"""Port of K3, the z-band conv probe of scripts/microbench_pallas.py.

K3's function is the one-pass branch of pallas_conv.zband_conv at k = 3,
and its counterpart is the port's zband_conv at k = 3: its plain version
is held against the Pallas one-pass kernel in interpret mode and against
the XLA band matmuls, f32 at rtol 1e-5 / atol 1e-5 (the same f32 sums in
another order). The port's microbenchmark entry point runs here on the
CPU in f32, where every z-band variant must agree with the halo variant
within 1e-5 of its max-abs. scripts/microbench_pallas.py is not imported:
importing it points JAX's compilation cache into the repo."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sps_tpu.ops import brick as jbk
from sps_tpu.ops import pallas_conv as pc
from sps_torch.ops import brick as tbk
from sps_torch.ops import zband_conv as zc
from sps_torch.scripts import microbench_zband as mb

TOL = dict(rtol=1e-5, atol=1e-5)
REL_TOL_CPU = 1e-5


@pytest.mark.parametrize("bs,tc,tco,b", [(4, 2, 2, 8), (8, 2, 2, 16), (4, 2, 3, 8)],
                         ids=["bs4", "bs8", "ragged"])
def test_k3_function_matches_pallas_onepass(bs, tc, tco, b):
    rng = np.random.default_rng(bs + tco)
    h = bs + 2
    hz = rng.standard_normal((b, h, h, h * tc)).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, tc, tco)).astype(np.float32)
    wz = np.array(jbk.pack_zband_kernel(jnp.asarray(w), bs, 1))
    np.testing.assert_array_equal(tbk.pack_zband_kernel(torch.from_numpy(w), bs, 1).numpy(), wz)
    # K3 shares the one-pass kernel body: make sure that is the branch taken.
    assert pc._pick_g_onepass(b, 3, h, bs, hz.shape[3], wz.shape[-1], 4) > 0
    got = zc.zband_conv_ref(torch.from_numpy(hz), torch.from_numpy(wz), 3, bs).numpy()
    want = pc.zband_conv(jnp.asarray(hz), jnp.asarray(wz), 3, bs, 8, True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    want_x = pc._band_matmul_xla(jnp.asarray(hz), jnp.asarray(wz), 3, bs)
    np.testing.assert_allclose(got, np.asarray(want_x), **TOL)


def test_microbench_entry_point_on_cpu():
    launches0 = dict(zc.LAUNCHES)
    res = mb.main(["--device", "cpu", "--dtype", "f32", "--b", "8", "--bs", "4",
                   "--tc", "2", "--iters", "1"])
    assert zc.LAUNCHES == launches0 and res["launches"] == 0
    assert list(res["variants"]) == list(mb.VARIANTS)
    for name, r in res["variants"].items():
        assert r["ms"] is None and r["tflops"] is None  # nothing is timed on the CPU
        if name != "halo":
            assert r["rel_err"] <= REL_TOL_CPU, (name, r["rel_err"])
    kc = res["variants"]["kernel-conv"]
    assert kc["max_abs_err"] == 0.0  # on the CPU the wrapper is the plain version
    # What chip_smoke.py phase 5 reads.
    for key in ("device", "dtype", "hz", "wz", "gflop_band", "gbytes", "bound_ms",
                "bound_by", "plain_ms", "launches"):
        assert key in res, key
    for key in ("ms", "max_abs_err", "out_max_abs", "bar"):
        assert key in kc, key
    assert res["device"] == "cpu" and res["hz"] == [8, 6, 6, 12] and res["wz"] == [3, 3, 12, 8]
    # band FLOPs: 2 * B*bs^2 * 9 * (bs+2)*tc * bs*tco; bytes: hz + wz + out in f32.
    assert res["gflop_band"] * 1e9 == pytest.approx(2 * 8 * 16 * 9 * 12 * 8)
    assert res["gbytes"] * 1e9 == pytest.approx(4 * (8 * 6 * 6 * 12 + 9 * 12 * 8 + 8 * 16 * 8))
    assert res["bound_by"] == "bytes"


def test_microbench_ragged_runs_halo_only():
    res = mb.main(["--device", "cpu", "--dtype", "f32", "--b", "8", "--bs", "4",
                   "--tc", "2", "--tcout", "3"])
    assert list(res["variants"]) == ["halo"]


def test_microbench_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mb.main([])
