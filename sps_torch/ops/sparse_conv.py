"""Row-level sparse convolutions (counterpart of sps_tpu/ops/sparse_conv.py).

Features are (V, T*C) rows over a 3D voxel set with a (V, T) occupancy
mask; time is packed into channel blocks, so a 4D conv with time kernel KT
becomes a 3D conv whose per-offset weight is a block-Toeplitz (T*Cin,
T*Cout) matrix. Phantom (voxel, t) slots are masked to exact zeros. These
serve the deep (L3/L4) row levels of the atlas pyramid.

Row gathers are index_select: its gradient is an index_add_, which on an
H100 took a training step's gathers from ~1.07 s to ~17 ms against
the sort-based transpose of advanced indexing (x[idx]). Where an index
repeats (neighbour tables, parents) the adds are atomics, so the bf16
gradient's last bits may differ between runs.
"""

from __future__ import annotations

import torch


def take_rows(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather rows of (V, ...) feats at idx (...,), 0 where idx < 0."""
    out = torch.index_select(feats, 0, idx.clamp(min=0).reshape(-1).long()).reshape(
        idx.shape + feats.shape[1:])
    mask = (idx >= 0).to(feats.dtype)
    return out * mask.reshape(mask.shape + (1,) * (out.dim() - mask.dim()))


def pack_time_toeplitz(w: torch.Tensor, num_time: int) -> torch.Tensor:
    """(K, KT, Cin, Cout) -> (K, T*Cin, T*Cout) block-Toeplitz matrices.

    The (t_in, t_out) block is W[., dt = t_in - t_out] (zero when
    |dt| > KT//2), MinkowskiEngine's 4D conv semantics."""
    k, kt, cin, cout = w.shape
    r = kt // 2
    rows = []
    for t_in in range(num_time):
        row = []
        for t_out in range(num_time):
            dt = t_in - t_out
            if -r <= dt <= r:
                row.append(w[:, dt + r])
            else:
                row.append(w.new_zeros((k, cin, cout)))
        rows.append(torch.cat(row, dim=-1))
    return torch.cat(rows, dim=-2)


def sparse_conv(feats, nbr, w_packed, occ, *, mask_out: bool = True):
    """Stride-1 sparse conv: out[i] = sum_k F[nbr[k, i]] @ W[k].

    One flat row gather in (V_out, K*TCin) order feeding one matmul; absent
    neighbours (nbr = -1) gather a trailing zero row.
    feats (V, T*Cin); nbr (K, V_out); w_packed (K, T*Cin, T*Cout); occ (V_out, T)."""
    k, v = nbr.shape
    tc = feats.shape[1]
    fz = torch.cat([feats, feats.new_zeros((1, tc))], dim=0)
    idx = torch.where(nbr >= 0, nbr, feats.shape[0]).T.reshape(-1).long()
    g = torch.index_select(fz, 0, idx).reshape(v, k * tc)
    out = g @ w_packed.reshape(k * tc, w_packed.shape[-1])
    return mask_slots(out, occ) if mask_out else out


def sparse_conv_down(feats, child, w_packed, occ_coarse, *, mask_out: bool = True):
    """Kernel-2 stride-2 conv: gather the 8 children of each coarse row."""
    return sparse_conv(feats, child, w_packed, occ_coarse, mask_out=mask_out)


def sparse_conv_up(feats, parent, parity, w_packed, occ_fine, *, mask_out: bool = True):
    """Transpose kernel-2 stride-2 conv: fine voxel u receives coarse voxel
    floor(u/2) through weight W[u mod 2] only (the parity)."""
    gathered = take_rows(feats, parent)  # (V_fine, T*Cin)
    prod = torch.einsum("vc,pcd->vpd", gathered, w_packed)  # (V_fine, 8, T*Cout)
    idx = parity.long()[:, None, None].expand(-1, 1, prod.shape[-1])
    out = torch.gather(prod, 1, idx)[:, 0]
    return mask_slots(out, occ_fine) if mask_out else out


def mask_slots(feats: torch.Tensor, occ: torch.Tensor) -> torch.Tensor:
    """Zero features of phantom (voxel, t) slots: feats (..., T*C), occ (..., T),
    any leading shape. The occupancy broadcasts over each slot's C channels
    (no channel-repeated copy)."""
    t = occ.shape[-1]
    x = feats.reshape(feats.shape[:-1] + (t, -1)) * occ[..., None].to(feats.dtype)
    return x.reshape(feats.shape)


def masked_batch_stats(feats: torch.Tensor, occ: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel mean and biased variance over real (voxel, t) slots:
    feats (V, T*C), occ (V, T) -> ((C,), (C,)). All time slots mix (ME's
    MinkowskiBatchNorm); phantom slots do not count, and the count is
    max(sum(occ), 1)."""
    v, tc = feats.shape
    t = occ.shape[1]
    x = feats.reshape(v, t, tc // t)
    w = occ.to(feats.dtype)[:, :, None]
    cnt = torch.clamp_min(occ.sum(dtype=torch.float32).to(feats.dtype), 1.0)
    mean = (x * w).sum(dim=(0, 1)) / cnt
    var = (w * (x - mean) ** 2).sum(dim=(0, 1)) / cnt
    return mean, var


def masked_batch_moments(feats: torch.Tensor, occ: torch.Tensor):
    """Per-channel raw moments over real (voxel, t) slots: (sum, sum of
    squares, count), additive across shards, so a spatially sharded
    BatchNorm sums them over the sp axis and forms mean = s1 / n and var =
    s2 / n - mean^2 (sps_tpu's one-pass form under sp)."""
    v, tc = feats.shape
    t = occ.shape[1]
    x = feats.reshape(v, t, tc // t)
    w = occ.to(feats.dtype)[:, :, None]
    s1 = (x * w).sum(dim=(0, 1))
    s2 = (x * x * w).sum(dim=(0, 1))
    return s1, s2, occ.sum(dtype=torch.float32).to(feats.dtype)
