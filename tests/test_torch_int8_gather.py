"""The gather form of the int8 brick conv (sps_torch/csrc/brick_conv_int8.cu):
each brick's halo gathered through nbr27 inside the kernel. On the CPU:
its copies replayed on numpy shared memory against ops/brick.halo, the
empty-brick exit, the shape rule, and the routing of
sps_torch.ops.brick.brick_conv_int8 through it, bit-equal to the halo
tensor and the halo form it replaces. No JAX compile.
"""

import dataclasses

import numpy as np
import pytest
import torch
from test_torch_model import CAPS, TCFG, _points

from sps_torch.models import spsnet as tsps
from sps_torch.ops import brick as bk
from sps_torch.ops import brick_conv_int8 as bi8
from sps_torch.structs import pad_point_batch as tpad

# chip_smoke.py's INT8_CALLS: the shipping path's int8 convs (config.yaml at
# batch 1) as (call, B, TCin, TCout).
PATH_CALLS = [
    ("block8_0.conv1", 11264, 32, 16), ("block8_0.conv2", 11264, 16, 16),
    ("block1_0.conv1/conv2", 3072, 16, 16), ("block7_0.conv1", 3072, 48, 32),
    ("block7_0.conv2", 3072, 32, 32), ("block2_0.conv1", 1024, 16, 32),
    ("block2_0.conv2", 1024, 32, 32), ("block6_0.conv1", 1024, 96, 64),
    ("block6_0.conv2", 1024, 64, 64),
]


def _table(rng, b, num_bricks, absent=0.35):
    """A (27, b) int32 neighbour table: the centre row on itself, random
    rows below num_bricks with `absent` of them -1, every row of the slots
    past num_bricks -1 (the atlas's empty slots)."""
    nbr = rng.integers(0, num_bricks, (27, b)).astype(np.int32)
    nbr[rng.random((27, b)) < absent] = -1
    nbr[13, :num_bricks] = np.arange(num_bricks)
    nbr[:, num_bricks:] = -1
    return nbr


def _codes(rng, b, c, bs=8):
    return rng.integers(-127, 128, (b, bs, bs, bs, c)).astype(np.int8)


@pytest.mark.parametrize("c", [16, 48, 96])
def test_gather_replay_places_the_halo(c):
    """Every brick's 16-byte copies, placed by gather_piece into a numpy
    shared-memory buffer (999 where not written, zeros where the copy
    zero-fills), hold ops/brick.halo's halo of that brick at the kernel's
    row stride; an empty slot's pieces read nothing."""
    rng = np.random.default_rng(c)
    b, num_bricks = 7, 5
    q8 = _codes(rng, b, c)
    nbr = _table(rng, b, num_bricks)
    want = bk.halo(torch.from_numpy(q8), torch.from_numpy(nbr), 1).numpy()
    s = bi8.row_stride(c)
    flat = q8.reshape(-1)
    for brick in range(b):
        smem = np.full(1000 * s, 999, np.int64)
        for i in range(1000 * c // 16):
            src, dst = bi8.gather_piece(i, nbr[:, brick], c)
            if src is None:
                smem[dst : dst + 16] = 0
            else:
                smem[dst : dst + 16] = flat[src : src + 16]
        placed = smem.reshape(1000, s)
        np.testing.assert_array_equal(placed[:, :c], want[brick].reshape(1000, c))
        assert (placed[:, c:] == 999).all()
        if brick >= num_bricks:
            assert not want[brick].any()
            assert all(bi8.gather_piece(i, nbr[:, brick], c)[0] is None
                       for i in range(1000 * c // 16))
    # The plain version's halo is ops/brick.halo's.
    np.testing.assert_array_equal(
        bi8.halo_gather_ref(torch.from_numpy(q8), torch.from_numpy(nbr)).numpy(), want)


@pytest.mark.parametrize("neighbours", ["absent", "present"])
def test_empty_bricks_give_zeros(neighbours):
    """A brick whose centre row is -1 gives +0.0 in the plain version (the
    kernel's early exit), also when other rows of its column are present,
    and gather_piece reads nothing for it; the other bricks equal the halo
    form on the gathered halo."""
    rng = np.random.default_rng(3)
    b, c, n = 4, 32, 16
    q8 = torch.from_numpy(_codes(rng, b, c))
    nbr = _table(rng, b, b, absent=0.0 if neighbours == "present" else 1.0)
    nbr[13, 2] = -1
    nbr = torch.from_numpy(nbr)
    w8 = torch.from_numpy(rng.integers(-127, 128, (3, 3, 3, c, n)).astype(np.int8))
    scale = torch.full((n,), 1e-3)
    for dtype in (torch.float32, torch.bfloat16):
        got = bi8.brick_conv_int8_gather(q8, nbr, w8, scale, dtype)
        assert got.shape == (b, 8, 8, 8, n) and got.dtype == dtype
        assert (got[2] == 0).all() and not torch.signbit(got[2]).any()
        want = bi8.brick_conv_int8(bk.halo(q8, nbr, 1), w8, scale, dtype)
        torch.testing.assert_close(got[[0, 1, 3]], want[[0, 1, 3]], rtol=0, atol=0)
        if neighbours == "present":  # the halo form would not give zeros there
            assert want[2].any()
    assert all(bi8.gather_piece(i, nbr[:, 2].numpy(), c)[0] is None for i in range(2000))


@pytest.mark.parametrize("call,b,c,n", PATH_CALLS, ids=[p[0] for p in PATH_CALLS])
def test_shape_rule_takes_every_call_of_the_path(call, b, c, n):
    assert bi8.takes_gather((b, 8, 8, 8, c), (27, b), (3, 3, 3, c, n)), call
    # B need not equal Bq: one output brick per column of nbr27.
    assert bi8.takes_gather((b + 5, 8, 8, 8, c), (27, b), (3, 3, 3, c, n))


@pytest.mark.parametrize("q_shape,nbr_shape,w_shape", [
    ((4, 8, 8, 8, 32, 1), (27, 4), (3, 3, 3, 32, 16)),   # q8 rank 6
    ((4, 512, 32), (27, 4), (3, 3, 3, 32, 16)),          # q8 rank 3
    ((4, 4, 4, 4, 32), (27, 4), (3, 3, 3, 32, 16)),      # brick side 4
    ((4, 8, 8, 8, 24), (27, 4), (3, 3, 3, 24, 16)),      # C % 16 != 0
    ((4, 8, 8, 8, 8), (27, 4), (3, 3, 3, 8, 16)),        # C % 16 != 0
    ((4, 8, 8, 8, 32), (27, 4), (3, 3, 3, 32, 8)),       # N = 8
    ((4, 8, 8, 8, 32), (26, 4), (3, 3, 3, 32, 16)),      # nbr27 not (27, B)
    ((4, 8, 8, 8, 32), (4, 27), (3, 3, 3, 32, 16)),
    ((4, 8, 8, 8, 32), (27, 4, 1), (3, 3, 3, 32, 16)),
    ((4, 8, 8, 8, 32), (27 * 4,), (3, 3, 3, 32, 16)),
    ((4, 8, 8, 8, 32), (27, 4), (3, 3, 3, 16, 16)),      # C of q8 and w8 differ
    ((4, 8, 8, 8, 32), (27, 4), (5, 5, 5, 32, 16)),      # k = 5
])
def test_shape_rule_refuses(q_shape, nbr_shape, w_shape):
    assert not bi8.takes_gather(q_shape, nbr_shape, w_shape)


def test_wrapper_counts_only_kernel_launches():
    """The plain version runs only for CPU tensors and counts no launch;
    elsewhere the wrapper launches the kernel or raises."""
    q8 = torch.zeros((2, 8, 8, 8, 16), dtype=torch.int8)
    nbr = torch.full((27, 2), -1, dtype=torch.int32)
    w8 = torch.zeros((3, 3, 3, 16, 16), dtype=torch.int8)
    bi8.reset_launches()
    out = bi8.brick_conv_int8_gather(q8, nbr, w8, torch.ones(16), torch.float32)
    assert not out.any()
    assert bi8.GATHER_LAUNCHES == {"brick_conv_int8_gather": 0}
    assert bi8.LAUNCHES == {"brick_conv_int8": 0}
    with pytest.raises(ValueError):
        bi8.brick_conv_int8_gather(q8.to("meta"), nbr.to("meta"), w8.to("meta"),
                                   torch.ones(16, device="meta"), torch.float32)


def test_kernel_source_has_the_gather_form():
    from sps_torch.ops import zband_conv as zc

    src = bi8.SOURCE.read_text()
    assert "sps_brick_conv_int8_gather" in src and "cp_async16_zfill" in src
    op = zc.OP_SOURCE.read_text()
    assert 'm.impl("brick_conv_int8_gather", &brick_conv_int8_gather)' in op


def _conv_case(seed, b, c, n, dtype):
    rng = np.random.default_rng(seed)
    occ = (rng.random((b, 8, 8, 8, 2)) < 0.4).astype(np.float32)
    occ[b - 1] = 0.0
    f = rng.standard_normal((b, 8, 8, 8, 2, c // 2)).astype(np.float32) * occ[..., None]
    nbr = _table(rng, b, b - 1)
    w = (rng.standard_normal((3, 3, 3, c, n)) * 0.2).astype(np.float32)
    return (torch.from_numpy(f.reshape(b, 8, 8, 8, c)).to(dtype), torch.from_numpy(nbr),
            torch.from_numpy(w), torch.from_numpy(occ))


def _halo_form(q8, nbr27, w8, scale, out_dtype):
    """What ops/brick.brick_conv_int8 ran before the gather form: the halo
    tensor of the codes, then the halo form."""
    return bi8.brick_conv_int8(bk.halo(q8, nbr27, 1), w8, scale, out_dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_brick_conv_int8_routes_through_the_gather_form(dtype, monkeypatch):
    """bk.brick_conv_int8 hands the codes and nbr27 themselves to
    brick_conv_int8_gather, assembles no halo, and gives what the halo
    tensor and the halo form gave, bit for bit."""
    f, nbr, w, occ = _conv_case(5, 6, 32, 16, dtype)
    before = None
    with monkeypatch.context() as m:
        m.setattr(bi8, "brick_conv_int8_gather", _halo_form)
        before = bk.brick_conv_int8(f, nbr, w, occ)
    calls = []
    real = bi8.brick_conv_int8_gather

    def spy(q8, nbr27, w8, scale, out_dtype):
        calls.append((q8, nbr27))
        return real(q8, nbr27, w8, scale, out_dtype)

    def no_halo(*args, **kwargs):
        raise AssertionError("the int8 path assembled a halo")

    monkeypatch.setattr(bi8, "brick_conv_int8_gather", spy)
    monkeypatch.setattr(bk, "halo", no_halo)
    got = bk.brick_conv_int8(f, nbr, w, occ)
    assert len(calls) == 1
    q8, nbr27 = calls[0]
    assert nbr27 is nbr
    torch.testing.assert_close(q8, bk.quantize_act(f)[0], rtol=0, atol=0)
    assert got.dtype == dtype
    torch.testing.assert_close(got, before, rtol=0, atol=0)


def test_model_int8_path_runs_the_gather_form(monkeypatch):
    """SPSModel with conv_mode halo, int8 and head_fold: every int8 conv
    reaches the gather form with contiguous int8 codes and a contiguous
    int32 nbr27 (what the kernel takes without a copy), and the scores are
    bit-equal to the halo tensor and the halo form."""
    cfg = dataclasses.replace(TCFG, unet=dataclasses.replace(
        TCFG.unet, conv_mode="halo", int8=True, head_fold=True))
    model = tsps.SPSModel(cfg)
    model.load_state_dict(tsps.init_state_dict(cfg, seed=0), strict=True)
    model.eval()
    pb = tpad(*_points(3), CAPS["points"], device="cpu")

    def run():
        with torch.inference_mode():
            levels, p2s, _ = tsps.build_pyramid(pb, cfg)
            return model(levels=levels, p2v=p2s, t_idx=pb.t, valid=pb.valid)[0]

    with monkeypatch.context() as m:
        m.setattr(bi8, "brick_conv_int8_gather", _halo_form)
        before = run()
    seen = []
    real = bi8.brick_conv_int8_gather

    def spy(q8, nbr27, w8, scale, out_dtype):
        seen.append((q8.dtype, q8.is_contiguous(), nbr27.dtype, nbr27.is_contiguous(),
                     q8.shape[0] == nbr27.shape[1]))
        return real(q8, nbr27, w8, scale, out_dtype)

    monkeypatch.setattr(bi8, "brick_conv_int8_gather", spy)
    got = run()
    assert len(seen) == 10  # the ten 3^3 BasicBlock convs at L0-L2
    assert set(seen) == {(torch.int8, True, torch.int32, True, True)}
    torch.testing.assert_close(got, before, rtol=0, atol=0)
