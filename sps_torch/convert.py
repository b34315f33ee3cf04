"""Weights carried across from sps_tpu's flax tree.

`state_dict_from_jax` takes the tree {"params": ..., "batch_stats": ...}
with numpy leaves (jax.tree.map(np.asarray, variables)) and returns a
state_dict for sps_torch.models.spsnet.SPSModel.load_state_dict(strict=True).
`load_npz` reads a trained checkpoint exported to an npz by
scripts/export_torch_assets.py (leaves keyed by their tree path,
"params/MinkUNet/block8_0/conv1/kernel"; f32), e.g.
sps_torch/assets/ckpt_loc_movers_v2.npz. `load_me_ckpt` reads the
reference's MinkowskiEngine checkpoints (a Lightning .ckpt or a bare
state_dict; counterpart of sps_tpu/convert.py::torch_ckpt_to_variables) and
`state_dict_from_me` maps their keys and kernel layouts (SPS, MOS4D and
MapMOS modules). `load_weights` also reads the port's own trainer
checkpoints (sps_torch.utils.checkpoint). Of the baselines, MOS4D and
MapMOS share SPSModel's MinkUNet tree; LTS's flax Dense kernels become
nn.Linear weights (`baseline_state_dict_from_jax`, `load_baseline_npz`).
Names mirror flax's (MinkUNet.block8_0.conv1.kernel,
MinkUNet.block8_0.norm1.{scale,bias,mean,var}); kernels keep their
(k^3, kt, Cin, Cout) layout with x-slowest offsets, and the torch modules
pack them as sps_tpu does.
"""

from __future__ import annotations

import itertools
import os

import numpy as np
import torch

from sps_torch.utils import checkpoint


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


def npz_tree(path: str) -> dict:
    """An exported npz (leaves keyed by tree path) -> the nested numpy tree."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return tree


def load_npz(path: str) -> dict[str, torch.Tensor]:
    """An exported checkpoint npz -> SPSModel state_dict."""
    return state_dict_from_jax(npz_tree(path))


def baseline_state_dict_from_jax(model: str, variables_np: dict) -> dict[str, torch.Tensor]:
    """sps_tpu's variables of baseline `model` ("mos4d", "mapmos" or "lts";
    numpy leaves) -> the port's state_dict. MOS4D and MapMOS share SPSModel's
    MinkUNet tree; for LTS a flax Dense's (in, out) kernel becomes
    nn.Linear's (out, in) weight, and BN1d keeps scale/bias/mean/var."""
    if model not in ("mos4d", "mapmos", "lts"):
        raise ValueError(f"unknown baseline {model!r}")
    sd = state_dict_from_jax(variables_np)
    if model != "lts":
        return sd
    return {(k[:-len("kernel")] + "weight" if k.endswith(".kernel") else k):
            (v.T.contiguous() if k.endswith(".kernel") else v) for k, v in sd.items()}


def load_baseline_npz(path: str, model: str) -> dict[str, torch.Tensor]:
    """An exported baseline npz (baselines_r5_<model>.npz) -> its state_dict."""
    return baseline_state_dict_from_jax(model, npz_tree(path))


# The reference's MinkowskiEngine (ME) layout. ME stores a conv kernel as
# (K_total, Cin, Cout) with its offsets enumerated dimension 0 (x) fastest
# and time slowest; the port keeps (K_space, K_time, Cin, Cout) with x
# slowest (kernel_offsets). The permutation is computed from both
# enumerations. A wrong one still loads strictly, with wrong weights:
# tests/test_me_order.py pins ME's order, tests/test_torch_convert_me.py
# holds this loader against sps_tpu's.


def kernel_offsets(size: int) -> np.ndarray:
    """Centred offsets of an odd kernel, (size**3, 3), x slowest / z fastest."""
    r = size // 2
    return np.asarray(list(itertools.product(range(-r, r + 1), repeat=3)), np.int32)


def _me_offsets(size: int, dims: int) -> np.ndarray:
    """ME hypercube offsets, dimension 0 fastest. Odd sizes centred, size 2
    uses {0, 1} (ME's convention for even kernels)."""
    rng = range(-(size // 2), size // 2 + 1) if size % 2 == 1 else range(size)
    return np.asarray([tuple(reversed(t)) for t in itertools.product(*([list(rng)] * dims))],
                      np.int32)


def _perm_spatial(size: int) -> np.ndarray:
    """perm[k_ours] = k_me for a purely spatial kernel (time kernel 1)."""
    ours = kernel_offsets(size) if size % 2 == 1 else np.asarray(
        list(itertools.product((0, 1), repeat=3)), np.int32)
    lut = {tuple(o): i for i, o in enumerate(_me_offsets(size, 3))}
    return np.asarray([lut[tuple(o)] for o in ours], np.int64)


def _me_offsets_4d(size: int, kt: int) -> np.ndarray:
    rs, rt = size // 2, kt // 2
    rng_s = list(range(-rs, rs + 1)) if size % 2 == 1 else list(range(size))
    rng_t = list(range(-rt, rt + 1)) if kt % 2 == 1 else list(range(kt))
    return np.asarray([(x, y, z, t) for t in rng_t for z in rng_s for y in rng_s
                       for x in rng_s], np.int32)


def _split_4d(w: np.ndarray, size: int, kt: int) -> np.ndarray:
    """ME (K_total, Cin, Cout) 4D kernel -> (K_space, K_time, Cin, Cout)."""
    if w.shape[0] != size**3 * kt:
        raise ValueError(f"kernel of shape {w.shape} is not {size}^3 x {kt}")
    rt = kt // 2
    lut = {tuple(o): i for i, o in enumerate(_me_offsets_4d(size, kt))}
    out = np.zeros((size**3, kt, w.shape[1], w.shape[2]), w.dtype)
    for ks, (dx, dy, dz) in enumerate(kernel_offsets(size)):
        for dt in range(-rt, rt + 1):
            out[ks, dt + rt] = w[lut[(dx, dy, dz, dt)]]
    return out


def _conv(sd, prefix, size, kt):
    w = sd.pop(prefix + ".kernel")
    if w.ndim == 2:  # 1x1: ME stores (Cin, Cout)
        out = {"kernel": w[None, None]}
    elif kt == 1:
        out = {"kernel": w[_perm_spatial(size)][:, None]}
    else:
        out = {"kernel": _split_4d(w, size, kt)}
    if prefix + ".bias" in sd:
        out["bias"] = sd.pop(prefix + ".bias").reshape(-1)
    return out


def _bn(sd, prefix):
    """MinkowskiBatchNorm -> (scale, bias) parameters and (mean, var) statistics."""
    return ({"scale": sd.pop(prefix + ".bn.weight"), "bias": sd.pop(prefix + ".bn.bias")},
            {"mean": sd.pop(prefix + ".bn.running_mean"),
             "var": sd.pop(prefix + ".bn.running_var")})


# The reference modules' key prefixes: SPS and MOS4D (predict.py:56-58,
# mos4d_node.py:65-69) and MapMOS (mapmos_node.py:48-53).
ME_PREFIXES = ("model.MinkUNet.", "mos.MinkUNet.")


def _strip_me_prefix(key: str) -> str:
    for p in ME_PREFIXES:
        if key.startswith(p):
            return key[len(p):]
    return key


def state_dict_from_me(sd: dict, *, layers=(1,) * 8, first_kernel: int = 5,
                       block_kernel: int = 3) -> dict[str, torch.Tensor]:
    """A reference state_dict (ME layout, keys with or without one of
    ME_PREFIXES, tensors or arrays) -> the state_dict of a MinkUNet model
    (SPSModel, MOS4DNet, MapMOSNet). Raises when a tensor of the input is
    left unused."""
    sd = {_strip_me_prefix(k): (v.detach().cpu().numpy() if hasattr(v, "detach")
                                else np.asarray(v))
          for k, v in sd.items() if "num_batches_tracked" not in k}
    params: dict = {}
    stats: dict = {}

    def put_bn(dst, src, p_node, s_node):
        p_node[dst], s_node[dst] = _bn(sd, src)

    params["conv0p1s1"] = _conv(sd, "conv0p1s1", first_kernel, 1)
    put_bn("bn0", "bn0", params, stats)
    for i in (1, 2, 3, 4):
        params[f"conv{i}p{2**(i-1)}s2"] = _conv(sd, f"conv{i}p{2**(i-1)}s2", 2, 1)
        put_bn(f"bn{i}", f"bn{i}", params, stats)
    for i in (4, 5, 6, 7):
        params[f"convtr{i}p{2**(8-i)}s2"] = _conv(sd, f"convtr{i}p{2**(8-i)}s2", 2, 1)
        put_bn(f"bntr{i}", f"bntr{i}", params, stats)
    for bi in range(1, 9):
        for li in range(layers[bi - 1]):
            src, dst = f"block{bi}.{li}", f"block{bi}_{li}"
            bp: dict = {}
            bs: dict = {}
            bp["conv1"] = _conv(sd, f"{src}.conv1", block_kernel, block_kernel)
            bp["conv2"] = _conv(sd, f"{src}.conv2", block_kernel, block_kernel)
            put_bn("norm1", f"{src}.norm1", bp, bs)
            put_bn("norm2", f"{src}.norm2", bp, bs)
            if f"{src}.downsample.0.kernel" in sd:
                bp["downsample_conv"] = _conv(sd, f"{src}.downsample.0", 1, 1)
                put_bn("downsample_norm", f"{src}.downsample.1", bp, bs)
            params[dst], stats[dst] = bp, bs
    params["final"] = _conv(sd, "final", 1, 1)
    if sd:
        raise ValueError(f"state_dict keys not consumed: {sorted(sd)[:8]}")
    return state_dict_from_jax({"params": {"MinkUNet": params},
                                "batch_stats": {"MinkUNet": stats}})


def load_me_ckpt(path: str, sps_cfg) -> dict[str, torch.Tensor]:
    """A reference .ckpt (Lightning or a bare state_dict) -> SPSModel
    state_dict for `sps_cfg` (an SPSConfig). Loads tensors only
    (weights_only); the MOSLoss keys of the reference's loss module are
    dropped."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt["state_dict"] if "state_dict" in ckpt else ckpt
    sd = {k: v for k, v in sd.items() if "MOSLoss" not in k}
    u = sps_cfg.unet
    return state_dict_from_me(sd, layers=u.layers, first_kernel=u.first_kernel,
                              block_kernel=u.block_kernel)


def load_weights(path: str, sps_cfg) -> dict[str, torch.Tensor]:
    """SPSModel state_dict from an exported .npz, a checkpoint of the port's
    trainer (sps_torch.utils.checkpoint) or a reference .ckpt."""
    if path.endswith(".npz"):
        return load_npz(path)
    item = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(item, dict) and item.get("format") == checkpoint.FORMAT:
        return dict(item["model"])
    return load_me_ckpt(path, sps_cfg)
