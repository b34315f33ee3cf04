"""Seeded MinkUNet14 weights in MinkowskiEngine's layout, made on the device.

One torch.Generator on the device, seeded from the run's seed, draws every
tensor in two calls (one normal, one uniform draw over all entries):
kernels He-normal over their fan-out (std sqrt(2 / (K * Cout)), as
MinkowskiEngine initialises them), the head's bias 0.1 N(0, 1), and BN
with weight 1 + 0.1 N, bias 0.1 N, running mean 0.3 N and running variance
0.5 + U(0, 1).

`calibrated` then makes them behave like a trained network's on the run's
own data: one train-mode pass of the reference over a scan's sites sets
each BN's running statistics to that scan's batch statistics, so that
every layer's output is of unit scale, and scales the head so that its
logits have a standard deviation of HEAD_LOGIT_STD, so that the scores
spread over (0, 1) around the threshold instead of saturating. Both the
program (through its ME loader) and the reference receive these tensors.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import minkunet as mk

HEAD_LOGIT_STD = 1.5


def me_state_dict(arch: mk.Arch, seed: int, device) -> dict:
    shapes = mk.me_shapes(arch)
    sizes = [math.prod(s) for _, s, _ in shapes]
    g = torch.Generator(device=device).manual_seed(seed)
    normal = torch.randn(sum(sizes), generator=g, device=device)
    uniform = torch.rand(sum(sizes), generator=g, device=device)
    out, i = {}, 0
    for (key, shape, kind), n in zip(shapes, sizes):
        z, u = normal[i : i + n].reshape(shape), uniform[i : i + n].reshape(shape)
        i += n
        if kind == "kernel":
            fan_out = (shape[0] if len(shape) == 3 else 1) * shape[-1]
            out[key] = z * math.sqrt(2.0 / fan_out)
        elif kind == "bias" or kind == "bn_bias":
            out[key] = 0.1 * z
        elif kind == "bn_weight":
            out[key] = 1.0 + 0.1 * z
        elif kind == "bn_mean":
            out[key] = 0.3 * z
        else:
            out[key] = 0.5 + u
    return out


def calibrated(arch: mk.Arch, seed: int, device, pyr: mk.Pyramid) -> dict:
    """me_state_dict with BN running statistics and the head's scale set
    from one train-mode reference pass over the sites of `pyr`."""
    w = me_state_dict(arch, seed, device)
    rec: dict = {}
    feats = torch.full((len(pyr.levels[0]), arch.in_channels), 0.5, device=device)
    with torch.no_grad():
        mk.forward(w, pyr, feats, arch, train=True, record=rec)
        head_input = rec.pop("head_input")
        for prefix, (mean, var) in rec.items():
            w[f"{prefix}.bn.running_mean"] = mean.clone()
            w[f"{prefix}.bn.running_var"] = var.clone()
        logits = head_input @ w["final.kernel"]
        w["final.kernel"] = w["final.kernel"] * (HEAD_LOGIT_STD / logits.std().clamp_min(1e-6))
    return w
