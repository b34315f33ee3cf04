"""MinkUNet14 over the atlas brick pyramid (counterpart of sps_tpu/models/minkunet.py).

Topology of the reference's MinkUNet14 (PLANES (8,16,32,64,64,32,16,8),
INIT_DIM 8, one BasicBlock per stage, D=4 with time packed into channel
blocks): conv0 (5^3) -> 4x [down s2 + BasicBlock] -> 4x [transpose s2 +
skip concat + BasicBlock] -> 1x1 head.

Module and parameter names mirror sps_tpu's flax tree (conv0p1s1, bn0,
block8_0.conv1, ...) so weights carry across by name (sps_torch/convert.py).
`nn.Module.training` is flax's `train` flag: in training MaskedBatchNorm
normalises with the batch's statistics over real slots and updates its
running averages once per forward; in eval mode it uses the running
statistics. The fused z-band epilogue and the int8 convs are
inference-only, as in sps_tpu. With `remat` each BasicBlock runs under
torch.utils.checkpoint in training (its activations recomputed in the
backward, the running statistics left alone by the recomputation).

Levels come from one of three engines: the atlas engine's mixed pyramid
(brick levels, ops.brick.BrickLevel, at L0-L2 and aliased voxel-row
levels, ops.atlas.RowLevel, at L3/L4), the brick engine's five brick
levels, or the gather engine's five voxel-row levels (ops.topology.Level,
one neighbour table per kernel size). With conv_mode "zband" the first
`zband_levels` brick levels run in the z-folded layout (B, bs, bs,
bs*TC): the stride-1 convs there go through the zband_conv kernels,
BasicBlocks through the fused kernel. Other brick levels run the conv
mode's dense brick conv ("region" or "halo"; "halo" under "zband"), row
levels the row-gather conv. With int8 the 3^3 convs of unfolded brick
levels run as int8 convs (the brick_conv_int8 kernel); with head_fold
the 1x1 head runs on the z-folded layout. With stem_zband the k = 5 stem
alone runs folded (in bf16 the zband_conv kernel's "wgmma_k5" route, or
"wgmma_k5_wide" at the C = 48 stem of dist_feature), then unfolds.

With sp_axis set the UNet runs spatially sharded (parallel/spatial.py):
levels come sliced to this rank's block of rows, every conv with a spatial
kernel assembles its gather source (the all-gathered level, or local +
ghost rows) and keeps the local block as its centre, train-mode BatchNorm
sums its moments over the axis, and the fused z-band epilogue, stem_zband
and head_fold are off, as in sps_tpu.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Sequence

import torch
from torch import nn
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from sps_torch.ops import atlas as atl
from sps_torch.ops import brick as bk
from sps_torch.ops import sparse_conv as sc
from sps_torch.parallel import comm
from sps_torch.parallel import spatial as sp_mod


@dataclasses.dataclass(frozen=True)
class MinkUNetConfig:
    in_channels: int = 1
    out_channels: int = 1
    init_dim: int = 8
    planes: tuple = (8, 16, 32, 64, 64, 32, 16, 8)
    layers: tuple = (1, 1, 1, 1, 1, 1, 1, 1)
    num_time: int = 2
    first_kernel: int = 5
    block_kernel: int = 3
    # Compute dtype for features and packed weights; parameters stay f32.
    dtype: torch.dtype = torch.float32
    # Brick stride-1 conv formulation: "region" (a SAME conv within each
    # brick plus one small conv per neighbour region), "halo" (a dense conv
    # over the assembled halo), or "zband", which folds levels
    # [0, zband_levels) and runs the rest as "halo". Kernels other than 3^3
    # run "halo" under every mode, as in sps_tpu.
    conv_mode: str = "region"
    zband_levels: int = 1
    # Inference-only int8 math for the 3^3 convs of unfolded brick levels
    # (ops.brick.brick_conv_int8), quantized from the f32 master kernels.
    int8: bool = False
    # Run the k = 5 stem alone in the z-folded layout (brick level 0 not
    # folded already): the folded halo, the zband_conv kernel, BN and relu
    # folded, then unfold.
    stem_zband: bool = False
    # Recompute each BasicBlock's activations in the backward (training).
    remat: bool = False
    # Run the 1x1 head on the z-folded layout (same memory order).
    head_fold: bool = False
    # Spatial sharding (parallel/spatial.py): the mesh axis over which every
    # level's brick / row axis is split (None: one device), and with
    # sp_ghost_frac > 0 the ghost exchange in place of each conv's
    # all-gather, ghost capacity sp_ghost_frac * block per source level.
    sp_axis: str | None = None
    sp_ghost_frac: float = 0.0


def _kaiming(shape, generator=None):
    """He-normal, fan_out over (K*KT, Cin, Cout) conv kernels."""
    k, kt, _, cout = shape
    std = (2.0 / (k * kt * cout)) ** 0.5
    return torch.randn(shape, generator=generator) * std


def _is_brick(lvl) -> bool:
    return isinstance(lvl, bk.BrickLevel)


def _is_row(lvl) -> bool:
    return isinstance(lvl, atl.RowLevel)


def occ_of(lvl):
    return lvl.grid.occ  # (V, T) or (B, bs, bs, bs, T)


def cat_time(a, b, num_time):
    """Skip concat per time slot (ME.cat): both operands live on the same
    coordinate set. z-folded operands (4-D) interleave per (z, t) block."""
    t = num_time * (a.shape[1] if a.dim() == 4 else 1)
    ab = torch.cat([a.reshape(a.shape[:-1] + (t, -1)), b.reshape(b.shape[:-1] + (t, -1))], -1)
    return ab.reshape(a.shape[:-1] + (-1,))


BN_MOMENTUM = 0.1  # weight of the batch in the running averages (torch's)


class MaskedBatchNorm(nn.Module):
    """BatchNorm over real (voxel, t) slots (ME MinkowskiBatchNorm); re-masks
    phantom slots. Accepts feats (..., T*C) with occ (..., T), unfolded or
    z-folded.

    Training: mean and biased variance of the batch over occupied slots,
    the affine applied in f32, masked, cast to the compute dtype; the
    running averages take momentum 0.1 of the batch's mean and unbiased
    variance (count clamped at 2), torch's convention, so converted
    checkpoints evaluate identically. Eval: the running statistics, in the
    compute dtype. `update_stats` False keeps the running averages (set
    while remat recomputes a block). With sp_axis the batch's statistics are
    the moments (sum, sum of squares, count) summed over the axis, var =
    s2 / n - mean^2, as sps_tpu's."""

    def __init__(self, features: int, eps: float = 1e-5, sp_axis: str | None = None):
        super().__init__()
        self.features = features
        self.eps = eps
        self.sp_axis = sp_axis
        self.update_stats = True
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def affine(self):
        """Per-channel f32 (scale', bias') with BN(x) = x*scale' + bias' under
        running statistics (fused into the zband kernel's epilogue)."""
        inv = 1.0 / torch.sqrt(self.var + self.eps)
        return (inv * self.scale).float(), (self.bias - self.mean * inv * self.scale).float()

    def forward(self, feats, occ):
        dtype = feats.dtype
        if not self.training:
            s, b = self.affine()
            x = feats.reshape(feats.shape[:-1] + (occ.shape[-1], self.features))
            return sc.mask_slots((x * s.to(dtype) + b.to(dtype)).reshape(feats.shape), occ)
        t = occ.shape[-1]
        f2 = feats.reshape(-1, feats.shape[-1]).float()
        o2 = occ.reshape(-1, t)
        if self.sp_axis is None:
            mean, var = sc.masked_batch_stats(f2, o2)
            cnt = torch.clamp_min(o2.sum(dtype=torch.float32), 2.0)
        else:
            c = self.features
            s1, s2, n = sc.masked_batch_moments(f2, o2)
            tot = comm.psum(torch.cat([s1, s2, n[None]]), self.sp_axis)
            s1, s2, n = tot[:c], tot[c : 2 * c], tot[2 * c]
            cnt = torch.clamp_min(n, 2.0)
            mean = s1 / torch.clamp_min(n, 1.0)
            var = torch.clamp_min(s2 / torch.clamp_min(n, 1.0) - mean**2, 0.0)
        if self.update_stats:
            with torch.no_grad():
                m = BN_MOMENTUM
                self.mean.copy_((1 - m) * self.mean + m * mean)
                self.var.copy_((1 - m) * self.var + m * (var * cnt / (cnt - 1.0)))
        # The per-channel affine rounds to the compute dtype, as sps_tpu's.
        inv = 1.0 / torch.sqrt(var + self.eps)
        s = (inv * self.scale).to(dtype).repeat(t)
        b = (self.bias - mean * inv * self.scale).to(dtype).repeat(t)
        return sc.mask_slots((f2 * s + b).to(dtype), o2).reshape(feats.shape)


class SpConv(nn.Module):
    """Stride-1 sparse conv (brick or row level)."""

    def __init__(self, cin, cout, ksize, time_kernel, num_time, *, use_bias=False,
                 conv_mode="region", mask_out=True, int8=False, sp_axis=None, generator=None):
        super().__init__()
        self.ksize, self.num_time = ksize, num_time
        self.conv_mode, self.mask_out, self.int8 = conv_mode, mask_out, int8
        self.sp_axis = sp_axis
        self.kernel = nn.Parameter(_kaiming((ksize**3, time_kernel, cin, cout), generator))
        self.bias = nn.Parameter(torch.zeros(cout)) if (use_bias and ksize == 1) else None

    def forward(self, feats, lvl, occ, epilogue=None):
        """epilogue (folded zband brick levels): dict with per-channel BN
        'scale'/'bias', channel-repeated 'occ_rep', optional masked 'res' and
        'relu', fused into the zband_conv_fused kernel."""
        w = self.kernel.to(feats.dtype)
        center = None
        if self.sp_axis is not None and self.ksize > 1:
            # feats is the local block; the tables name source rows.
            center = feats
            feats = sp_mod.gather_source(feats, lvl, "self", self.sp_axis)
        if self.ksize == 1:
            wp = sc.pack_time_toeplitz(w, self.num_time)[0]
            reps = self.num_time
            if feats.dim() == 4:
                # z-folded: block-diagonal weight (kron with I_bs).
                bs = feats.shape[1]
                wp = torch.kron(torch.eye(bs, dtype=wp.dtype, device=wp.device), wp)
                reps = self.num_time * bs
            out = feats @ wp
            if self.bias is not None:
                out = out + self.bias.repeat(reps).to(out.dtype)
            return sc.mask_slots(out, occ) if self.mask_out else out
        if _is_brick(lvl):
            wd = bk.pack_dense_kernel(w, self.num_time)
            if feats.dim() == 4:
                if epilogue is not None:
                    return bk.brick_conv_zband_fused(
                        feats, lvl.nbr27, wd, epilogue["scale"], epilogue["bias"],
                        epilogue["occ_rep"], epilogue.get("res"),
                        num_time=self.num_time, relu=epilogue.get("relu", True),
                    )
                return bk.brick_conv_zband(feats, lvl.nbr27, wd, occ, mask_out=self.mask_out,
                                           center=center)
            if self.int8 and self.ksize == 3 and not self.training:
                # Inference only. Quantize from the f32 master kernel, not
                # the compute-dtype cast.
                wd8 = bk.pack_dense_kernel(self.kernel, self.num_time)
                return bk.brick_conv_int8(feats, lvl.nbr27, wd8, occ, mask_out=self.mask_out,
                                          center=center)
            # Unfolded levels under "zband" use the halo assembly; kernels
            # other than 3^3 run "halo" under every mode (bk.brick_conv).
            mode = "halo" if self.conv_mode == "zband" else self.conv_mode
            return bk.brick_conv(feats, lvl.nbr27, wd, occ, mode, mask_out=self.mask_out,
                                 center=center)
        wp = sc.pack_time_toeplitz(w, self.num_time)
        if _is_row(lvl):
            assert self.ksize == 3, "row levels carry 27-neighbour tables only"
            return sc.sparse_conv(feats, lvl.nbr27, wp, occ, mask_out=self.mask_out)
        # A gather-engine level (ops.topology.Level): the neighbour table of
        # this kernel size (the 5^3 stem gathers 125 rows a voxel).
        return sc.sparse_conv(feats, lvl.nbr[self.ksize], wp, occ, mask_out=self.mask_out)


class SpConvDown(nn.Module):
    """Kernel (2,2,2,1), stride (2,2,2,1) conv."""

    def __init__(self, cin, cout, num_time, *, mask_out=True, sp_axis=None, generator=None):
        super().__init__()
        self.num_time, self.mask_out, self.sp_axis = num_time, mask_out, sp_axis
        self.kernel = nn.Parameter(_kaiming((8, 1, cin, cout), generator))

    def forward(self, feats, coarse_lvl, fold_out=False):
        """fold_out: return z-folded (the target level is zband-folded)."""
        wp = sc.pack_time_toeplitz(self.kernel.to(feats.dtype), self.num_time)
        occ = occ_of(coarse_lvl)
        if self.sp_axis is not None:
            feats = sp_mod.gather_source(feats, coarse_lvl, "child", self.sp_axis)
        if _is_brick(coarse_lvl):
            fin = feats
            if feats.dim() == 4:  # z-folded source level: unfold for the gather
                fin = bk.unfold_z(feats, feats.shape[-1] // feats.shape[1])
            out = bk.brick_conv_down(fin, coarse_lvl.child, wp, occ, mask_out=self.mask_out)
            return bk.fold_z(out) if fold_out else out
        # Row level: brick-form sources (5-D, or 4-D folded) flatten to slot
        # rows in memory order (z-major, t, c minor); child indexes them.
        if feats.dim() == 5:
            feats = feats.reshape(-1, feats.shape[-1])
        elif feats.dim() == 4:
            feats = feats.reshape(-1, feats.shape[-1] // feats.shape[1])
        return sc.sparse_conv_down(feats, coarse_lvl.child, wp, occ, mask_out=self.mask_out)


class SpConvUp(nn.Module):
    """Transpose conv (2,2,2,1) stride 2."""

    def __init__(self, cin, cout, num_time, *, mask_out=True, sp_axis=None, generator=None):
        super().__init__()
        self.num_time, self.mask_out, self.sp_axis = num_time, mask_out, sp_axis
        self.kernel = nn.Parameter(_kaiming((8, 1, cin, cout), generator))

    def forward(self, feats, fine_lvl, fold_out=False):
        """fold_out: return z-folded (the target level is zband-folded)."""
        wp = sc.pack_time_toeplitz(self.kernel.to(feats.dtype), self.num_time)
        occ = occ_of(fine_lvl)
        if self.sp_axis is not None:
            feats = sp_mod.gather_source(feats, fine_lvl, "parent", self.sp_axis)
        if _is_brick(fine_lvl):
            if fine_lvl.parent_rows is not None:
                # Brick/row boundary: coarse side is voxel rows.
                f2 = feats if feats.dim() == 2 else feats.reshape(-1, feats.shape[-1])
                out = bk.brick_conv_up_from_rows(f2, fine_lvl.parent_rows, wp, occ,
                                                 mask_out=self.mask_out)
            else:
                fin = feats
                if feats.dim() == 4:
                    fin = bk.unfold_z(feats, feats.shape[-1] // feats.shape[1])
                out = bk.brick_conv_up(fin, fine_lvl.parent, fine_lvl.oct, wp, occ,
                                       mask_out=self.mask_out)
            return bk.fold_z(out) if fold_out else out
        return sc.sparse_conv_up(feats, fine_lvl.parent, fine_lvl.parity, wp, occ,
                                 mask_out=self.mask_out)


class BasicBlock(nn.Module):
    """Residual unit: conv3-bn-relu-conv3-bn (+1x1 shortcut) -> relu.

    Every conv feeds a MaskedBatchNorm, which re-masks, so the convs skip
    their own output mask; inputs to convs stay fully masked (phantom slots
    exactly zero), as the halo and neighbour gathers require."""

    def __init__(self, cin, planes, num_time, block_kernel=3, conv_mode="region",
                 int8=False, remat=False, sp_axis=None, generator=None):
        super().__init__()
        self.cin, self.planes, self.conv_mode, self.remat = cin, planes, conv_mode, remat
        self.sp_axis = sp_axis
        t = num_time
        self.conv1 = SpConv(cin, planes, block_kernel, 3, t, conv_mode=conv_mode,
                            mask_out=False, int8=int8, sp_axis=sp_axis, generator=generator)
        self.norm1 = MaskedBatchNorm(planes, sp_axis=sp_axis)
        self.conv2 = SpConv(planes, planes, block_kernel, 3, t, conv_mode=conv_mode,
                            mask_out=False, int8=int8, sp_axis=sp_axis, generator=generator)
        self.norm2 = MaskedBatchNorm(planes, sp_axis=sp_axis)
        if cin != planes:
            self.downsample_conv = SpConv(cin, planes, 1, 1, t, mask_out=False,
                                          generator=generator)
            self.downsample_norm = MaskedBatchNorm(planes, sp_axis=sp_axis)

    def _residual(self, feats, lvl, occ):
        if self.cin == self.planes:
            return feats
        return self.downsample_norm(self.downsample_conv(feats, lvl, occ), occ)

    @contextlib.contextmanager
    def _frozen_stats(self):
        """The block's BNs leave their running averages alone (remat's
        recomputation repeats the forward, which must not update them twice)."""
        norms = [m for m in self.modules() if isinstance(m, MaskedBatchNorm)]
        for m in norms:
            m.update_stats = False
        try:
            yield
        finally:
            for m in norms:
                m.update_stats = True

    def forward(self, feats, lvl, occ):
        if self.remat and self.training and torch.is_grad_enabled():
            return checkpoint(self._forward, feats, lvl, occ, use_reentrant=False,
                              context_fn=lambda: (contextlib.nullcontext(), self._frozen_stats()))
        return self._forward(feats, lvl, occ)

    def _forward(self, feats, lvl, occ):
        if (not self.training and self.sp_axis is None and self.conv_mode == "zband"
                and _is_brick(lvl) and feats.dim() == 4):
            # Folded zband level: conv + BN (+ residual) + relu + mask fused
            # into the kernel epilogue. occ * relu(x*s+b) == relu(occ*(x*s+b))
            # for occ in {0, 1}, so this equals the unfused path.
            occ_rep = occ.repeat_interleave(self.planes, dim=-1).to(feats.dtype)
            s1, b1 = self.norm1.affine()
            out = self.conv1(feats, lvl, occ, epilogue={
                "scale": s1, "bias": b1, "occ_rep": occ_rep, "relu": True})
            s2, b2 = self.norm2.affine()
            res = self._residual(feats, lvl, occ)
            return self.conv2(out, lvl, occ, epilogue={
                "scale": s2, "bias": b2, "occ_rep": occ_rep, "res": res, "relu": True})
        out = torch.relu(self.norm1(self.conv1(feats, lvl, occ), occ))
        out = self.norm2(self.conv2(out, lvl, occ), occ)
        return torch.relu(out + self._residual(feats, lvl, occ))


class MinkUNet(nn.Module):
    """The UNet body. Inputs: level-0 features plus the prebuilt 5-level pyramid."""

    def __init__(self, cfg: MinkUNetConfig, generator=None):
        super().__init__()
        self.cfg = cfg
        t, p, d0 = cfg.num_time, cfg.planes, cfg.init_dim
        g, sp = generator, cfg.sp_axis
        self.conv0p1s1 = SpConv(cfg.in_channels, d0, cfg.first_kernel, 1, t,
                                conv_mode=cfg.conv_mode, mask_out=False, sp_axis=sp, generator=g)
        self.bn0 = MaskedBatchNorm(d0, sp_axis=sp)
        enc = [("conv1p1s2", "bn1", d0, d0, d0, p[0]),
               ("conv2p2s2", "bn2", p[0], p[0], p[0], p[1]),
               ("conv3p4s2", "bn3", p[1], p[1], p[1], p[2]),
               ("conv4p8s2", "bn4", p[2], p[2], p[2], p[3])]
        dec = [("convtr4p16s2", "bntr4", p[3], p[4], p[4] + p[2], p[4]),
               ("convtr5p8s2", "bntr5", p[4], p[5], p[5] + p[1], p[5]),
               ("convtr6p4s2", "bntr6", p[5], p[6], p[6] + p[0], p[6]),
               ("convtr7p2s2", "bntr7", p[6], p[7], p[7] + d0, p[7])]
        self.stages = []
        for i, (conv, bn, cin, cout, bcin, planes) in enumerate(enc + dec):
            cls = SpConvDown if i < 4 else SpConvUp
            setattr(self, conv, cls(cin, cout, t, mask_out=False, sp_axis=sp, generator=g))
            setattr(self, bn, MaskedBatchNorm(cout, sp_axis=sp))
            blocks = []
            for j in range(cfg.layers[i]):
                name = f"block{i + 1}_{j}"
                setattr(self, name, BasicBlock(bcin if j == 0 else planes, planes, t,
                                               cfg.block_kernel, cfg.conv_mode,
                                               cfg.int8, cfg.remat, sp, generator=g))
                blocks.append(name)
            self.stages.append((conv, bn, blocks))
        self.final = SpConv(p[7], cfg.out_channels, 1, 1, t, use_bias=True, generator=g)

    def forward(self, feats: torch.Tensor, levels: Sequence) -> torch.Tensor:
        cfg = self.cfg
        t = cfg.num_time
        zband = cfg.conv_mode == "zband"
        fold = [zband and i < cfg.zband_levels and _is_brick(lv) for i, lv in enumerate(levels)]

        def occ_lvl(i, lv):
            o = occ_of(lv)
            return o.reshape(o.shape[0], o.shape[1], o.shape[2], -1) if fold[i] else o

        occ = [occ_lvl(i, lv) for i, lv in enumerate(levels)]
        if fold[0] and feats.dim() == 5:
            feats = bk.fold_z(feats)
        stem_fold = (cfg.stem_zband and cfg.sp_axis is None and not fold[0]
                     and _is_brick(levels[0]) and feats.dim() == 5)

        with record_function("sps.stem"):
            if stem_fold:
                o0 = occ[0]
                socc = o0.reshape(o0.shape[0], o0.shape[1], o0.shape[2], -1)
                x = self.conv0p1s1(bk.fold_z(feats), levels[0], socc)
                x = bk.unfold_z(torch.relu(self.bn0(x, socc)), t * cfg.init_dim)
            else:
                x = self.conv0p1s1(feats, levels[0], occ[0])
                x = torch.relu(self.bn0(x, occ[0]))
        skips = [x]
        # Encoder to L1..L4, then decoder back to L3..L0 with skip concats.
        targets = [1, 2, 3, 4, 3, 2, 1, 0]
        for i, (conv, bn, blocks) in enumerate(self.stages):
            li = targets[i]
            with record_function(f"sps.{conv}.L{li}"):
                y = getattr(self, conv)(x, levels[li], fold_out=fold[li])
                x = torch.relu(getattr(self, bn)(y, occ[li]))
                if i >= 4:
                    x = cat_time(x, skips[li], t)
                for name in blocks:
                    x = getattr(self, name)(x, levels[li], occ[li])
            if i < 3:
                skips.append(x)

        if cfg.head_fold and cfg.sp_axis is None and _is_brick(levels[0]) and x.dim() == 5:
            # Folded head: the 1x1 as the block-diagonal kron on the folded
            # layout, returned folded; its memory order is the unfolded
            # one's, so devoxelize_flat reads it unchanged.
            o0 = occ[0]
            occ_h = o0.reshape(o0.shape[0], o0.shape[1], o0.shape[2], -1)
            return self.final(bk.fold_z(x), levels[0], occ_h)
        return self.final(x, levels[0], occ[0])
