"""Train-mode MaskedBatchNorm of the port against sps_tpu's (flax apply with
train=True, mutable batch_stats) on the same features: outputs, the new
running mean/var and the gradients of the features, scale and bias, on the
unfolded (B, bs, bs, bs, T*C) and the z-folded (B, bs, bs, bs*T*C)
layouts, with a time slot that holds no occupied slot and with no occupied
slot at all, in f32 and bf16.

Tolerances: f32 outputs and statistics rtol/atol 1e-5 (sums in another
order); bf16 outputs within one bf16 ulp of the output scale (2**-7 of
max |out|): both sides compute in f32 from the same bf16 inputs and round
once, so a flip at a rounding tie is the only difference. Gradients in
f32, rtol/atol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sps_torch.models.minkunet import MaskedBatchNorm as TBN
from sps_tpu.models.minkunet import MaskedBatchNorm as JBN

B, BS, T, C = 3, 4, 2, 5


def _case(layout, occupancy, seed):
    rng = np.random.default_rng(seed)
    feats = rng.normal(0.7, 1.9, (B, BS, BS, BS, T * C)).astype(np.float32)
    occ = rng.random((B, BS, BS, BS, T)) < 0.4
    if occupancy == "slot_empty":
        occ[..., 1] = False  # time slot 1: no occupied slot anywhere
    elif occupancy == "none":
        occ[:] = False
    if layout == "folded":
        feats = feats.reshape(B, BS, BS, BS * T * C)
        occ = occ.reshape(B, BS, BS, BS * T)
    params = {"scale": rng.uniform(0.5, 1.5, C).astype(np.float32),
              "bias": rng.normal(0, 0.3, C).astype(np.float32)}
    stats = {"mean": rng.normal(0, 0.3, C).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, C).astype(np.float32)}
    cot = rng.normal(0, 1, feats.shape).astype(np.float32)
    return feats, occ, params, stats, cot


def _torch_bn(params, stats):
    bn = TBN(C)
    with torch.no_grad():
        for k, v in {**params, **stats}.items():
            getattr(bn, k).copy_(torch.from_numpy(v))
    return bn.train()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("occupancy", ["random", "slot_empty", "none"])
@pytest.mark.parametrize("layout", ["unfolded", "folded"])
def test_train_bn_matches_sps_tpu(layout, occupancy, dtype):
    feats, occ, params, stats, _ = _case(layout, occupancy, seed=len(layout) + len(occupancy))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want, mut = JBN(C).apply({"params": params, "batch_stats": stats},
                             jnp.asarray(feats, jdt), jnp.asarray(occ), True,
                             mutable=["batch_stats"])
    want = np.asarray(want.astype(jnp.float32))
    bn = _torch_bn(params, stats)
    ft = torch.from_numpy(feats).to(getattr(torch, dtype))
    got = bn(ft, torch.from_numpy(occ))
    assert got.dtype == ft.dtype and got.shape == ft.shape
    got = got.detach().float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(got - want).max() <= 2.0**-7 * max(np.abs(want).max(), 1e-6)
    # Phantom slots are exact zeros.
    occ_c = np.repeat(occ, C, axis=-1)
    assert (got[~occ_c] == 0).all()
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(bn, k).numpy(), np.asarray(mut["batch_stats"][k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    if occupancy == "none":  # the statistics of nothing: mean 0, var 0
        np.testing.assert_allclose(bn.mean.numpy(), 0.9 * stats["mean"], rtol=1e-6)


@pytest.mark.parametrize("layout", ["unfolded", "folded"])
def test_train_bn_gradients_match_sps_tpu(layout):
    feats, occ, params, stats, cot = _case(layout, "random", seed=11)

    def f(x, p):
        out, _ = JBN(C).apply({"params": p, "batch_stats": stats}, x, jnp.asarray(occ), True,
                              mutable=["batch_stats"])
        return out

    _, vjp = jax.vjp(f, jnp.asarray(feats), params)
    d_x, d_p = vjp(jnp.asarray(cot))
    bn = _torch_bn(params, stats)
    x = torch.from_numpy(feats).requires_grad_(True)
    (bn(x, torch.from_numpy(occ)) * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(d_x), rtol=1e-4, atol=1e-4)
    for k in ("scale", "bias"):
        np.testing.assert_allclose(getattr(bn, k).grad.numpy(), np.asarray(d_p[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)


def test_eval_bn_leaves_running_statistics():
    """Eval mode normalises with the running statistics and updates nothing;
    update_stats False (remat's recomputation) keeps them in training."""
    feats, occ, params, stats, _ = _case("unfolded", "random", seed=2)
    bn = _torch_bn(params, stats)
    bn.update_stats = False
    bn(torch.from_numpy(feats), torch.from_numpy(occ))
    bn.eval()
    bn(torch.from_numpy(feats), torch.from_numpy(occ))
    np.testing.assert_array_equal(bn.mean.numpy(), stats["mean"])
    np.testing.assert_array_equal(bn.var.numpy(), stats["var"])
