"""The brick engine (bricks with the hash topology) against sps_tpu's:
voxelize_bricks, downsample_bricks and build_brick_levels bit-equal at brick
sides 4 and 8; brick_conv in "region" mode against sps_tpu's region and the
port's halo mode; SPSModel on the brick engine at sps_tpu's defaults (brick
side 4, conv_mode region), f32 scores at rtol 1e-3 / atol 1e-4 (sps_tpu's
pinned by scripts/export_torch_assets.py --only spsmodel in
sps_torch/assets/spsmodel_pin.npz); with INT8
on at side 8; the int8 conv's channel-chunked launches (C > 128, the brick
engine's L3) against one launch's plain version, bit for bit. MapMOS on the
brick engine: tests/test_torch_mapmos_engines.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_gather_engine import CAPS, NARROW, T, _points, weights  # noqa: F401
from test_torch_stream import model_record, pinned

from sps_torch.models import spsnet as tsps
from sps_torch.models.minkunet import MinkUNetConfig as TUNetConfig
from sps_torch.ops import brick as tbk
from sps_torch.ops import brick_conv_int8 as bi8
from sps_torch.structs import Capacities as TCaps
from sps_torch.structs import pad_point_batch as tpad
from sps_tpu.ops import brick as jbk

BCAPS = (96, 64, 64, 32, 32)


def _vox(seed, n=700, span=40):
    rng = np.random.default_rng(seed)
    base = rng.integers(-span // 2, span // 2, size=(n // 2, 3))
    coords = base[rng.integers(0, len(base), size=n)].astype(np.int32)
    return (coords, rng.integers(0, 2, size=n).astype(np.int32),
            rng.integers(0, T, size=n).astype(np.int32), rng.random(n) > 0.1,
            rng.standard_normal((n, 2)).astype(np.float32))


def _eq(got, want, what):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=what)


def _check_grid(a, b, what):
    for name in ("coords", "occ", "num_bricks", "overflow"):
        _eq(getattr(a, name), getattr(b, name), f"{what}.{name}")
    _eq(a.table.keys, b.table.keys, f"{what}.table.keys")
    _eq(a.table.rows, b.table.rows, f"{what}.table.rows")


@pytest.mark.parametrize("bs", [4, 8])
def test_brick_topology_bit_equal(bs):
    coords, batch, t, valid, feats = _vox(bs)
    caps = BCAPS if bs == 4 else (64, 32, 16, 16, 16)

    def jrun(c, b, tt, v, f):
        g, p2s, pooled = jbk.voxelize_bricks(c, b, tt, v, num_time=T, brick_capacity=caps[0],
                                             features=f, brick_side=bs)
        return g, p2s, pooled, jbk.build_brick_levels(g, num_levels=5, capacities=caps)

    jg, jp2s, jpooled, jl = jax.jit(jrun)(*map(jnp.asarray, (coords, batch, t, valid, feats)))
    tg, tp2s, tpooled = tbk.voxelize_bricks(*map(torch.as_tensor, (coords, batch, t, valid)),
                                            num_time=T, brick_capacity=caps[0],
                                            features=torch.as_tensor(feats), brick_side=bs)
    _check_grid(tg, jg, "grid")
    _eq(tp2s, jp2s, "point2slot")
    _eq(tpooled, jpooled, "pooled")
    tl = tbk.build_brick_levels(tg, num_levels=5, capacities=caps)
    for li, (a, b) in enumerate(zip(tl, jl)):
        _check_grid(a.grid, b.grid, f"L{li}")
        for name in ("nbr27", "parent", "oct", "child"):
            x, y = getattr(a, name), getattr(b, name)
            assert (x is None) == (y is None), f"L{li}.{name}"
            if x is not None:
                _eq(x, y, f"L{li}.{name}")
    # A coarse capacity below the bricks there: downsample_bricks overflows.
    small = jax.jit(lambda g: jbk.downsample_bricks(g, 8))(jg)
    got = tbk.downsample_bricks(tg, 8)
    _check_grid(got[0], small[0], "downsample overflow")
    _eq(got[1], small[1], "fine2coarse")
    assert bool(got[0].overflow)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_brick_conv_region(dtype):
    """Region mode against sps_tpu's region (f32) and the port's halo mode
    (f32: the same sums in another order; bf16: within 2e-2 of max-abs)."""
    coords, batch, t, valid, _ = _vox(2)
    g, _ = tbk.voxelize_bricks(*map(torch.as_tensor, (coords, batch, t, valid)), num_time=T,
                               brick_capacity=BCAPS[0], brick_side=4)
    nbr27 = tbk.build_brick_levels(g, num_levels=5, capacities=BCAPS)[0].nbr27
    rng = np.random.default_rng(3)
    occ = g.occ.numpy()
    f = (rng.standard_normal(occ.shape[:-1] + (T * 3,)) * np.repeat(occ, 3, -1)).astype(
        np.float32)
    w = (rng.standard_normal((27, 3, 3, 5)) * 0.3).astype(np.float32)
    wd = tbk.pack_dense_kernel(torch.as_tensor(w), T)
    if dtype == "f32":
        want = jax.jit(jbk.brick_conv, static_argnums=4)(
            jnp.asarray(f), jnp.asarray(nbr27.numpy()), jnp.asarray(wd.numpy()),
            jnp.asarray(occ), "region")
        got = tbk.brick_conv(torch.as_tensor(f), nbr27, wd, g.occ, "region")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
        halo = tbk.brick_conv(torch.as_tensor(f), nbr27, wd, g.occ, "halo")
        np.testing.assert_allclose(got.numpy(), halo.numpy(), rtol=1e-4, atol=1e-5)
        assert np.abs(got.numpy()).max() > 0.1
    else:
        fb, wb = torch.as_tensor(f).bfloat16(), wd.bfloat16()
        got = tbk.brick_conv(fb, nbr27, wb, g.occ, "region").float()
        halo = tbk.brick_conv(fb, nbr27, wb, g.occ, "halo").float()
        assert (got - halo).abs().max() <= 2e-2 * halo.abs().max()


def brick_defaults(sps_config, caps, unet_config):
    """Either package's SPSConfig at its defaults (engine brick, brick side
    4, conv_mode region), narrowed, with the bricks this test's points need."""
    return sps_config(voxel_size=0.25, caps=caps(**dict(CAPS, bricks=(512, 256, 128, 64, 64))),
                      unet=unet_config(**NARROW))


def test_spsmodel_brick_engine_at_sps_tpus_defaults(weights):
    """engine brick, brick side 4, conv_mode region: sps_tpu's defaults."""
    sd, _ = weights
    tcfg = brick_defaults(tsps.SPSConfig, TCaps, TUNetConfig)
    assert (tcfg.engine, tcfg.brick_side, tcfg.unet.conv_mode) == ("brick", 4, "region")
    pts = _points(5)
    pin = pinned("spsmodel_pin.npz", "brick_defaults",
                 model_record(tcfg, sd, (*pts, CAPS["points"])))
    want, aux_j = pin["scores"], {"overflow": pin["overflow"]}
    model = tsps.SPSModel(tcfg)
    model.load_state_dict(sd, strict=True)
    model.eval()
    with torch.inference_mode():
        got, aux_t = model(tpad(*pts, CAPS["points"], device="cpu"))
    assert not bool(aux_t["overflow"].any()) and not bool(np.asarray(aux_j["overflow"]).any())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-4)


def test_int8_channel_chunks_equal_one_launch():
    """C = 192 (block5_0.conv1 at the brick engine's L3) exceeds the int8
    kernel's 128: six launches of 32 channels at scale 1, the int32 sums
    added, dequantized once, equal the plain version of one launch bit for
    bit (bf16 and f32)."""
    rng = np.random.default_rng(7)
    b, c, n = 12, 192, 128
    q = torch.as_tensor(rng.integers(-127, 128, (b, 8, 8, 8, c)), dtype=torch.int8)
    q[:, :, :2] = 127  # the largest sums
    nbr27 = torch.as_tensor(rng.integers(-1, b, (27, b)), dtype=torch.int32)
    w8 = torch.as_tensor(rng.integers(-127, 128, (3, 3, 3, c, n)), dtype=torch.int8)
    scale = torch.as_tensor(rng.uniform(1e-4, 1e-3, n), dtype=torch.float32)
    assert not bi8.takes_gather(q.shape, nbr27.shape, w8.shape)
    for dtype in (torch.float32, torch.bfloat16):
        want = bi8.brick_conv_int8_gather_ref(q, nbr27, w8, scale, dtype)
        got = tbk._int8_gather(q, nbr27, w8, scale, dtype)
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.float().numpy(), want.float().numpy())
    # A kernel-sized C takes one launch of the wrapper, unchanged.
    assert bi8.takes_gather((b, 8, 8, 8, 128), nbr27.shape, (3, 3, 3, 128, n))


def test_brick_engine_int8_runs_every_brick_level(weights, monkeypatch):
    """INT8 on the brick engine (side 8): the 3^3 convs of all five brick
    levels run int8 (16 convs), scores within 2e-2 of the float run (the
    narrow net's BN spreads one code step further than the card's check)."""
    calls = []
    real = tbk._int8_gather
    monkeypatch.setattr(tbk, "_int8_gather", lambda *a: calls.append(a[0].shape) or real(*a))
    caps = dict(CAPS, bricks=(160, 64, 32, 16, 16))
    cfg = tsps.SPSConfig(voxel_size=0.25, caps=TCaps(**caps), engine="brick", brick_side=8,
                         unet=TUNetConfig(**NARROW))
    pb = tpad(*_points(9), CAPS["points"], device="cpu")
    sd, _ = weights
    out = {}
    for int8 in (False, True):
        c = dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet, int8=int8))
        model = tsps.SPSModel(c)
        model.load_state_dict(sd, strict=True)
        model.eval()
        with torch.inference_mode():
            out[int8], aux = model(pb)
        assert not bool(aux["overflow"].any())
    assert len(calls) == 16
    assert (out[True] - out[False]).abs().max() <= 2e-2
