"""MinkUNet14 of SPS (CustomMinkUNet14, D = 4) in plain torch, float32.

The network as the reference repository defines it (ibrahimhroob/SPS,
customminkunet.py on MinkowskiEngine's MinkUNetBase): a 5^3 x 1 stem,
four stages of [2^3 x 1 stride-2 conv + BN + ReLU + BasicBlock], four of
[2^3 x 1 transposed conv + BN + ReLU + skip concat + BasicBlock], and a
1 x 1 head with bias. A BasicBlock is conv 3^4 - BN - ReLU - conv 3^4 - BN
(+ 1 x 1 conv + BN where the width changes) + residual, ReLU. Weights are
a MinkowskiEngine state_dict (keys without the `model.MinkUNet.` prefix).

Sites are (b, x, y, z, t) rows; convs follow ME's semantics
(benchmark/reference/sparse.py). Float32 by default. `lower` computes it
one precision below a configuration that runs bfloat16 with int8 3^4
convs at the levels `int8_levels` (the benchmark's control): those convs
take int4 codes (activations per tensor, weights per output channel), and
every other conv's operands and every layer's output are rounded to fp8
e4m3 with a per-tensor scale.
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark.reference import sparse as sp

BN_EPS = 1e-5
NUM_LEVELS = 5


@dataclasses.dataclass(frozen=True)
class Arch:
    planes: tuple = (8, 16, 32, 64, 64, 32, 16, 8)
    init_dim: int = 8
    in_channels: int = 1
    out_channels: int = 1
    first_kernel: int = 5
    block_kernel: int = 3
    block_time_kernel: int = 3

    @classmethod
    def of(cls, d: dict) -> "Arch":
        return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()})


def stages(a: Arch):
    """(conv name, bn name, block name, level, conv cin, conv cout, block
    cin, block planes) for the eight stages, encoder then decoder."""
    p, d0 = a.planes, a.init_dim
    enc = [("conv1p1s2", "bn1", "block1", 1, d0, d0, d0, p[0]),
           ("conv2p2s2", "bn2", "block2", 2, p[0], p[0], p[0], p[1]),
           ("conv3p4s2", "bn3", "block3", 3, p[1], p[1], p[1], p[2]),
           ("conv4p8s2", "bn4", "block4", 4, p[2], p[2], p[2], p[3])]
    dec = [("convtr4p16s2", "bntr4", "block5", 3, p[3], p[4], p[4] + p[2], p[4]),
           ("convtr5p8s2", "bntr5", "block6", 2, p[4], p[5], p[5] + p[1], p[5]),
           ("convtr6p4s2", "bntr6", "block7", 1, p[5], p[6], p[6] + p[0], p[6]),
           ("convtr7p2s2", "bntr7", "block8", 0, p[6], p[7], p[7] + d0, p[7])]
    return enc + dec


def me_shapes(a: Arch) -> list:
    """[(key, shape, kind)] of the ME state_dict; kind is "kernel" (with its
    fan-out K * Cout), "bias", or one of the BN entries."""
    out = []

    def bn(prefix, c):
        out.extend([(f"{prefix}.bn.weight", (c,), "bn_weight"),
                    (f"{prefix}.bn.bias", (c,), "bn_bias"),
                    (f"{prefix}.bn.running_mean", (c,), "bn_mean"),
                    (f"{prefix}.bn.running_var", (c,), "bn_var")])

    k0 = a.first_kernel ** 3
    out.append(("conv0p1s1.kernel", (k0, a.in_channels, a.init_dim), "kernel"))
    bn("bn0", a.init_dim)
    kb = a.block_kernel ** 3 * a.block_time_kernel
    for conv, bnn, block, _, cin, cout, bcin, planes in stages(a):
        out.append((f"{conv}.kernel", (8, cin, cout), "kernel"))
        bn(bnn, cout)
        out.append((f"{block}.0.conv1.kernel", (kb, bcin, planes), "kernel"))
        bn(f"{block}.0.norm1", planes)
        out.append((f"{block}.0.conv2.kernel", (kb, planes, planes), "kernel"))
        bn(f"{block}.0.norm2", planes)
        if bcin != planes:
            out.append((f"{block}.0.downsample.0.kernel", (bcin, planes), "kernel"))
            bn(f"{block}.0.downsample.1", planes)
    out.append(("final.kernel", (a.planes[7], a.out_channels), "kernel"))
    out.append(("final.bias", (1, a.out_channels), "bias"))
    return out


class Pyramid:
    """Five site levels from the finest, the stride-2 maps between them and
    the stride-1 kernel maps each level's convs use."""

    def __init__(self, sites0: sp.Sites, a: Arch):
        self.levels = [sites0]
        self.down = []
        for _ in range(NUM_LEVELS - 1):
            d = sp.Down(self.levels[-1])
            self.down.append(d)
            self.levels.append(d.coarse)
        self.stem = sp.neighbors(sites0, sp.me_offsets(a.first_kernel, 1))
        offs = sp.me_offsets(a.block_kernel, a.block_time_kernel)
        self.block = [sp.neighbors(s, offs) for s in self.levels]


FP8_MAX = 448.0


def _fp8(x):
    """x rounded to fp8 e4m3 with a per-tensor scale (amax -> FP8_MAX)."""
    s = torch.clamp_min(x.detach().abs().amax(), 1e-12) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s


def _int_codes(x, bits, dim=None):
    """Symmetric integer codes of x and their scale (per tensor, or per
    slice along the dims not in `dim`)."""
    qmax = float(2 ** (bits - 1) - 1)
    amax = x.abs().amax() if dim is None else x.abs().amax(dim=dim, keepdim=True)
    s = torch.clamp_min(amax, 1e-12) / qmax
    return torch.clamp(torch.round(x / s), -qmax, qmax), s


class Precision:
    """Identity in float32; the control's rounding when `lower`."""

    def __init__(self, lower: bool, int8_levels: tuple = ()):
        self.lower, self.int8_levels = lower, tuple(int8_levels)

    def out(self, x):
        return _fp8(x) if self.lower else x

    def conv(self, x, nbr, w, level=None):
        if not self.lower:
            return sp.conv(x, nbr, w)
        if level in self.int8_levels:
            qx, sx = _int_codes(x, 4)
            qw, sw = _int_codes(w, 4, dim=(0, 1))
            return _fp8(sp.conv(qx, nbr, qw) * (sx * sw.reshape(1, -1)))
        return _fp8(sp.conv(_fp8(x), nbr, _fp8(w)))

    def weight(self, w):
        return _fp8(w) if self.lower else w


class BatchNorm:
    """ME BatchNorm over the sites: running statistics in eval, the batch's
    (biased variance) in training, recorded into `record` when given."""

    def __init__(self, w: dict, prefix: str, train: bool, record: dict | None = None):
        self.w, self.p, self.train, self.record = w, prefix, train, record

    def __call__(self, x):
        w = self.w
        if self.train:
            mean = x.mean(dim=0)
            var = x.var(dim=0, unbiased=False)
            if self.record is not None:
                self.record[self.p] = (mean.detach(), var.detach())
        else:
            mean, var = w[f"{self.p}.bn.running_mean"], w[f"{self.p}.bn.running_var"]
        inv = torch.rsqrt(var + BN_EPS)
        return (x - mean) * (inv * w[f"{self.p}.bn.weight"]) + w[f"{self.p}.bn.bias"]


def forward(w: dict, pyr: Pyramid, feats0: torch.Tensor, a: Arch, *, train: bool = False,
            lower: bool = False, int8_levels: tuple = (), record: dict | None = None
            ) -> torch.Tensor:
    """Head output (N0, out_channels) at the finest level's sites. `record`
    (training) receives each BN's batch (mean, var) by prefix and the head's
    input under "head_input"."""
    pr = Precision(lower, int8_levels)

    def bn(prefix, x):
        return pr.out(BatchNorm(w, prefix, train, record)(x))

    def block(x, name, li, cin, planes):
        nbr = pyr.block[li]
        out = torch.relu(bn(f"{name}.0.norm1", pr.conv(x, nbr, w[f"{name}.0.conv1.kernel"], li)))
        out = bn(f"{name}.0.norm2", pr.conv(out, nbr, w[f"{name}.0.conv2.kernel"], li))
        if cin != planes:
            res = bn(f"{name}.0.downsample.1",
                     pr.out(pr.out(x) @ pr.weight(w[f"{name}.0.downsample.0.kernel"])))
        else:
            res = x
        return pr.out(torch.relu(out + res))

    x = torch.relu(bn("bn0", pr.conv(feats0, pyr.stem, w["conv0p1s1.kernel"])))
    skips = [x]
    for i, (conv, bnn, blk, li, _, _, bcin, planes) in enumerate(stages(a)):
        k = pr.weight(w[f"{conv}.kernel"])
        if i < 4:
            y = sp.conv_down(x, pyr.down[li - 1], k)
        else:
            y = sp.conv_up(x, pyr.down[li], k)
        x = torch.relu(bn(bnn, pr.out(y)))
        if i >= 4:
            x = torch.cat([x, skips[li]], dim=1)
        x = block(x, blk, li, bcin, planes)
        if i < 3:
            skips.append(x)
    if record is not None:
        record["head_input"] = x.detach()
    return pr.out(x @ pr.weight(w["final.kernel"]) + w["final.bias"])
