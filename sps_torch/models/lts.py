"""LTS stability filter: the SPCT offset-attention point transformer
(counterpart of sps_tpu/models/lts.py).

  * Embedding: two bias-free pointwise Dense layers with BN + relu, 3 -> 128.
  * Four stacked offset-attention blocks: q and k share one bias-free
    projection (C -> C/4), the softmax runs over keys and the result is
    L1-renormalised over queries (+1e-9); `trans` (Dense with bias) acts on
    x - attn(v), then BN + relu, and the block adds its input back.
  * Head: the four blocks' outputs (512) -> 2048 (bias-free, BN, leaky relu
    0.2), concatenated with their max and mean over the points (6144) ->
    512 -> 256 (Dense with bias, BN, silu) -> 1 -> sigmoid.

Dense layers are nn.Linear (torch's (out, in) weight; flax's kernel is
(in, out); sps_torch.convert.baseline_state_dict_from_jax transposes it).
In training (`model.train()`) BN1d normalizes with the batch's statistics
and updates its running ones, and dropout (rate 0.2 after the 512- and
256-wide layers) draws its mask from the torch.Generator passed to
forward; in eval mode dropout is the identity.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


BN_MOMENTUM = 0.1  # torch BatchNorm1d's, as sps_tpu's BN1d


class BN1d(nn.Module):
    """torch BatchNorm1d over (B, N, C) with running statistics, in
    sps_tpu's order: (x - mean) * (rsqrt(var + eps) * scale) + bias.

    In training the statistics are the f32 mean and biased variance over
    the B * N rows (padded rows too), and the running averages move by
    BN_MOMENTUM towards the mean and the unbiased variance var * n / (n - 1)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x):
        if self.training:
            x32 = x.float()
            mean = x32.mean(dim=(0, 1))
            var = x32.var(dim=(0, 1), unbiased=False)
            n = x.shape[0] * x.shape[1]
            m = BN_MOMENTUM
            with torch.no_grad():
                self.mean.copy_((1 - m) * self.mean + m * mean)
                self.var.copy_((1 - m) * self.var + m * var * n / max(n - 1, 1))
        else:
            mean, var = self.mean, self.var
        inv = 1.0 / torch.sqrt(var + self.eps)
        return ((x - mean) * (inv * self.scale) + self.bias).to(x.dtype)


def dropout(x, rate: float, training: bool, generator: torch.Generator | None):
    """flax's nn.Dropout: in training keep each element with probability
    1 - rate and scale it by 1 / (1 - rate), the mask drawn from
    `generator` (never torch's global RNG); the identity otherwise."""
    if not training or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("train-mode dropout needs an explicit torch.Generator")
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class OffsetAttention(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.qk = nn.Linear(channels, channels // 4, bias=False)  # shared q/k weight
        self.v = nn.Linear(channels, channels)
        self.trans = nn.Linear(channels, channels)
        self.after_norm = BN1d(channels)

    def forward(self, x):
        x_q = self.qk(x)  # (B, N, C/4)
        energy = torch.matmul(x_q, x_q.transpose(1, 2))
        attn = torch.softmax(energy, dim=-1)
        attn = attn / (1e-9 + attn.sum(dim=1, keepdim=True))
        x_r = torch.matmul(attn, self.v(x))
        x_r = torch.relu(self.after_norm(self.trans(x - x_r)))
        return x + x_r


class SPCTReg(nn.Module):
    def __init__(self, dropout: float = 0.2):
        super().__init__()
        self.dropout = dropout
        self.e1 = nn.Linear(3, 128, bias=False)
        self.ebn1 = BN1d(128)
        self.e2 = nn.Linear(128, 128, bias=False)
        self.ebn2 = BN1d(128)
        for i in range(1, 5):
            setattr(self, f"sa{i}", OffsetAttention(128))
        self.l1 = nn.Linear(512, 2048, bias=False)
        self.l1bn = BN1d(2048)
        self.l2 = nn.Linear(2048 * 3, 512)
        self.l2bn = BN1d(512)
        self.l3 = nn.Linear(512, 256)
        self.l3bn = BN1d(256)
        self.convs = nn.Linear(256, 1)

    def forward(self, xyz, generator: torch.Generator | None = None):
        """xyz (B, N, 3) -> (B, N) stability scores in [0, 1]. `generator`
        (on xyz's device) draws the dropout masks in training."""
        x = torch.relu(self.ebn1(self.e1(xyz)))
        x = torch.relu(self.ebn2(self.e2(x)))
        xs = []
        for i in range(1, 5):
            x = getattr(self, f"sa{i}")(x)
            xs.append(x)
        x = torch.cat(xs, dim=-1)  # (B, N, 512)
        x = F.leaky_relu(self.l1bn(self.l1(x)), negative_slope=0.2)
        x_max = x.amax(dim=1, keepdim=True).expand_as(x)
        x_mean = x.mean(dim=1, keepdim=True).expand_as(x)
        x = torch.cat([x, x_max, x_mean], dim=-1)  # (B, N, 6144)
        x = F.silu(self.l2bn(self.l2(x)))
        x = dropout(x, self.dropout, self.training, generator)
        x = F.silu(self.l3bn(self.l3(x)))
        x = dropout(x, self.dropout, self.training, generator)
        return torch.sigmoid(self.convs(x))[..., 0]


def init_state_dict(seed: int = 0, random_stats: bool = True) -> dict[str, torch.Tensor]:
    """Seeded random weights: U(+-1/sqrt(fan_in)) for every Dense weight and
    bias, and random running statistics (mean 0.1*N(0,1), var 0.5+U(0,1)),
    so that BN is not the identity; random_stats=False keeps BN1d's
    initial 0 / 1 (a model about to be trained)."""
    g = torch.Generator().manual_seed(seed)
    model = SPCTReg()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Linear):
                b = m.in_features ** -0.5
                m.weight.copy_((torch.rand(m.weight.shape, generator=g) * 2 - 1) * b)
                if m.bias is not None:
                    m.bias.copy_((torch.rand(m.bias.shape, generator=g) * 2 - 1) * b)
            elif isinstance(m, BN1d) and random_stats:
                m.mean.copy_(0.1 * torch.randn(m.mean.shape, generator=g))
                m.var.copy_(0.5 + torch.rand(m.var.shape, generator=g))
    return model.state_dict()
