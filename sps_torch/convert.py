"""Weights carried across from sps_tpu's flax tree.

`state_dict_from_jax` takes the tree {"params": ..., "batch_stats": ...}
with numpy leaves (jax.tree.map(np.asarray, variables)) and returns a
state_dict for sps_torch.models.spsnet.SPSModel.load_state_dict(strict=True).
`load_npz` reads a trained checkpoint exported to an npz by
scripts/export_torch_assets.py (leaves keyed by their tree path,
"params/MinkUNet/block8_0/conv1/kernel"; f32), e.g.
sps_torch/assets/ckpt_loc_movers_v2.npz.
Names mirror flax's (MinkUNet.block8_0.conv1.kernel,
MinkUNet.block8_0.norm1.{scale,bias,mean,var}); kernels keep their
(k^3, kt, Cin, Cout) layout with x-slowest offsets, and the torch modules
pack them as sps_tpu does.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _flatten(tree: dict, prefix: str, out: dict):
    for key, val in tree.items():
        name = f"{prefix}.{key}" if prefix else key
        if isinstance(val, dict):
            _flatten(val, name, out)
        else:
            out[name] = torch.from_numpy(np.array(val, dtype=np.float32))
    return out


def state_dict_from_jax(variables_np: dict) -> dict[str, torch.Tensor]:
    """flax variables with numpy leaves -> SPSModel state_dict."""
    sd: dict[str, torch.Tensor] = {}
    _flatten(variables_np["params"], "", sd)
    _flatten(variables_np.get("batch_stats", {}), "", sd)
    return sd


ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")


def load_npz(path: str) -> dict[str, torch.Tensor]:
    """An exported checkpoint npz -> SPSModel state_dict."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return state_dict_from_jax(tree)
