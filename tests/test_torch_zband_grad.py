"""zband_conv under autograd: the port's gradients (the plain backward
zband_conv_bwd behind the kernel's or plain version's forward) against
jax.vjp of sps_tpu.ops.pallas_conv.zband_conv run in interpret mode, at
k = 3 and 5, with respect to the halo and to the band-packed weight, and
through brick.pack_zband_kernel to the dense (k, k, k, TCin, TCout)
kernel. zband_conv_fused is inference-only: it raises when a gradient is
asked of an operand.

Tolerances: f32, sums of up to k*k*C products in another order, rtol/atol
1e-4 of the gradient's scale; bf16 (both sides sum in f32 and round once)
within 2e-2 of the gradient's max-abs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sps_torch.ops import brick as bk
from sps_torch.ops import zband_conv as zc
from sps_tpu.ops import brick as jbk
from sps_tpu.ops import pallas_conv as pc

CASES = [  # (k, bs, tcin, tcout, B)
    (3, 4, 2, 3, 5), (3, 8, 2, 2, 3), (5, 4, 1, 2, 4), (5, 8, 3, 2, 2),
]


def _case(k, bs, tcin, tcout, b, seed):
    rng = np.random.default_rng(seed)
    h = bs + k - 1
    hz = rng.normal(size=(b, h, h, h * tcin)).astype(np.float32)
    wd = (rng.normal(size=(k, k, k, tcin, tcout)) * (2.0 / (k**3 * tcin)) ** 0.5).astype(np.float32)
    dout = rng.normal(size=(b, bs, bs, bs * tcout)).astype(np.float32)
    return hz, wd, dout


def _close(got, want, dtype):
    scale = max(float(np.abs(want).max()), 1e-6)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)
    else:
        assert float(np.abs(got - want).max()) <= 2e-2 * scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=[f"k{c[0]}bs{c[1]}c{c[2]}n{c[3]}" for c in CASES])
def test_zband_conv_gradients_match_sps_tpu(case, dtype):
    k, bs, tcin, tcout, b = case
    hz, wd, dout = _case(*case, seed=sum(case))
    pad = k // 2
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)

    def jf(h, w):
        return pc.zband_conv(h, jbk.pack_zband_kernel(w, bs, pad), k, bs, interpret=True)

    out_j, vjp = jax.vjp(jf, jnp.asarray(hz, jdt), jnp.asarray(wd, jdt))
    d_hz_j, d_wd_j = vjp(jnp.asarray(dout, jdt))

    h_t = torch.from_numpy(hz).to(tdt).requires_grad_(True)
    w_t = torch.from_numpy(wd).to(tdt).requires_grad_(True)
    out_t = zc.zband_conv(h_t, bk.pack_zband_kernel(w_t, bs, pad), k, bs)
    assert type(out_t.grad_fn).__name__ == "_ZbandConvBackward"
    out_t.backward(torch.from_numpy(dout).to(tdt))
    assert h_t.grad.dtype == tdt and w_t.grad.dtype == tdt
    f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))  # noqa: E731
    _close(out_t.detach().float().numpy(), f32(out_j), dtype)
    _close(h_t.grad.float().numpy(), f32(d_hz_j), dtype)
    _close(w_t.grad.float().numpy(), f32(d_wd_j), dtype)


@pytest.mark.parametrize("k", [3, 5])
def test_band_weight_gradient_matches_sps_tpu(k):
    """d_wz of the packed band weight itself (the backward's second output)."""
    bs, tcin, tcout, b = 4, 2, 2, 3
    hz, wd, dout = _case(k, bs, tcin, tcout, b, seed=40 + k)
    wz = np.asarray(jbk.pack_zband_kernel(jnp.asarray(wd), bs, k // 2))
    _, vjp = jax.vjp(lambda h, w: pc.zband_conv(h, w, k, bs, interpret=True),
                     jnp.asarray(hz), jnp.asarray(wz))
    _, d_wz_j = vjp(jnp.asarray(dout))
    w_t = torch.tensor(wz, requires_grad=True)
    zc.zband_conv(torch.from_numpy(hz), w_t, k, bs).backward(torch.from_numpy(dout))
    _close(w_t.grad.numpy(), np.asarray(d_wz_j), "float32")
    d_hz, d_wz = zc.zband_conv_bwd(torch.from_numpy(hz), torch.from_numpy(wz),
                                   torch.from_numpy(dout), k, bs, need_hz=False)
    assert d_hz is None and torch.equal(d_wz, w_t.grad)


def test_zband_conv_fused_raises_under_a_gradient():
    k, bs, tcin, tcout, b = 3, 4, 2, 2, 2
    hz, wd, _ = _case(k, bs, tcin, tcout, b, seed=3)
    n = bs * tcout
    wz = bk.pack_zband_kernel(torch.from_numpy(wd), bs, 1)
    scale, bias = torch.ones(n), torch.zeros(n)
    occ = torch.ones((b, bs, bs, n))
    h = torch.from_numpy(hz)
    want = zc.zband_conv_fused(h, wz, scale, bias, occ, k=k, bs=bs)
    for name in ("hz", "wz", "scale"):
        args = {"hz": h, "wz": wz, "scale": scale}
        args[name] = args[name].clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match="inference-only"):
            zc.zband_conv_fused(args["hz"], args["wz"], args["scale"], bias, occ, k=k, bs=bs)
        with torch.no_grad():
            got = zc.zband_conv_fused(args["hz"], args["wz"], args["scale"], bias, occ,
                                      k=k, bs=bs)
        # The same values (a copy's alignment may pick another CPU matmul path).
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
