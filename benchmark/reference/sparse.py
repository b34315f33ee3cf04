"""Sparse 4-D convolution with MinkowskiEngine's semantics, in plain torch.

A site is a (b, x, y, z, t) row that holds features; every conv reads and
writes only sites that exist:
  * stride-1 conv, kernel K^3 x KT: out[u] = sum_off W[off] . in[u + off]
    over the offsets whose site u + off exists; output sites = input sites;
  * kernel 2^3 x 1 stride 2 (down): output sites are the distinct
    (b, x >> 1, y >> 1, z >> 1, t); out[c] = sum W[o] . in[2c + o];
  * its transpose (up) onto a given finer site set: out[u] = W[u & 1] . in[u >> 1].
Offsets follow ME's kernel layout: dimension 0 (x) fastest, time slowest.

Sites are found by sorting packed int64 keys and binary search; a conv
gathers each output site's neighbourhood (absent neighbours read a zero
row) and multiplies once, in blocks of output rows so that memory stays
bounded. Nothing here imports the program under test.
"""

from __future__ import annotations

import torch

# Packed key: 3 bits of batch, 19 bits per spatial axis (offset 2^18), 2 of t.
_SPATIAL_BITS, _T_BITS = 19, 2
_OFF = 1 << (_SPATIAL_BITS - 1)
ROW_BLOCK = 1 << 16


def pack(coords: torch.Tensor) -> torch.Tensor:
    """(N, 5) int64 [b, x, y, z, t] -> (N,) int64 keys (order: b, x, y, z, t)."""
    c = coords.long()
    k = c[:, 0]
    for i in (1, 2, 3):
        k = (k << _SPATIAL_BITS) | (c[:, i] + _OFF)
    return (k << _T_BITS) | c[:, 4]


class Sites:
    """A set of sites, sorted by key."""

    def __init__(self, coords: torch.Tensor):
        keys = pack(coords)
        self.keys, order = torch.sort(keys)
        self.coords = coords.long()[order]

    @classmethod
    def unique(cls, coords: torch.Tensor) -> "Sites":
        keys, idx = torch.unique(pack(coords), return_inverse=True)
        first = torch.full((len(keys),), len(coords), dtype=torch.long, device=coords.device)
        first.scatter_reduce_(0, idx, torch.arange(len(coords), device=coords.device), "amin")
        return cls(coords.long()[first])

    def __len__(self) -> int:
        return len(self.keys)

    def find(self, coords: torch.Tensor) -> torch.Tensor:
        """Row of each query site in this set, -1 where absent."""
        q = pack(coords)
        i = torch.searchsorted(self.keys, q).clamp(max=max(len(self.keys) - 1, 0))
        if len(self.keys) == 0:
            return torch.full_like(q, -1)
        return torch.where(self.keys[i] == q, i, -1)


def me_offsets(size: int, kt: int) -> torch.Tensor:
    """(size^3 * kt, 4) offsets [dx, dy, dz, dt] in ME's order (x fastest,
    t slowest); odd sizes are centred, size 2 is {0, 1}."""
    r = range(-(size // 2), size // 2 + 1) if size % 2 else range(size)
    rt = range(-(kt // 2), kt // 2 + 1)
    rows = [(x, y, z, t) for t in rt for z in r for y in r for x in r]
    return torch.tensor(rows, dtype=torch.long)


def neighbors(sites: Sites, offsets: torch.Tensor) -> torch.Tensor:
    """(K, N) row of site u + off for every output site u, -1 where absent."""
    c = sites.coords
    out = []
    for off in offsets.to(c.device):
        q = c.clone()
        q[:, 1:] += off
        ok = (q[:, 4] >= 0) & (q[:, 4] < (1 << _T_BITS))
        q[:, 4] = torch.where(ok, q[:, 4], 0)
        out.append(torch.where(ok, sites.find(q), -1))
    return torch.stack(out)


def conv(x: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """out[u] = sum_k x[nbr[k, u]] @ w[k]; x (N_in, Cin), nbr (K, N_out), w (K, Cin, Cout)."""
    k, n = nbr.shape
    xz = torch.cat([x, x.new_zeros((1, x.shape[1]))])
    wf = w.reshape(k * w.shape[1], w.shape[2])
    outs = []
    for s in range(0, n, ROW_BLOCK):
        idx = nbr[:, s : s + ROW_BLOCK]
        idx = torch.where(idx >= 0, idx, len(x)).T.reshape(-1)  # (rows * K,)
        # index_select: its gradient is an index_add, where autograd's
        # transpose of x[idx] sorts the indices.
        outs.append(xz.index_select(0, idx).reshape(-1, k * x.shape[1]) @ wf)
    return torch.cat(outs) if outs else x.new_zeros((0, w.shape[2]))


def pairs(nbr: torch.Tensor) -> int:
    """(output site, input site) pairs of a kernel map."""
    return int((nbr >= 0).sum())


class Down:
    """The stride-2 map from a finer site set: the coarse sites, each fine
    site's coarse row and its parity's offset index (ME order)."""

    def __init__(self, fine: Sites):
        c = fine.coords
        coarse = c.clone()
        coarse[:, 1:4] = c[:, 1:4] >> 1
        self.coarse = Sites.unique(coarse)
        self.fine_to_coarse = self.coarse.find(coarse)
        par = c[:, 1:4] & 1
        self.parity = par[:, 0] + 2 * par[:, 1] + 4 * par[:, 2]


def conv_down(x: torch.Tensor, d: Down, w: torch.Tensor) -> torch.Tensor:
    """out[c] = sum over fine sites f of c: x[f] @ w[parity(f)]; w (8, Cin, Cout)."""
    out = x.new_zeros((len(d.coarse), w.shape[2]))
    for o in range(8):
        sel = d.parity == o
        out = out.index_add(0, d.fine_to_coarse[sel], x[sel] @ w[o])
    return out


def conv_up(x: torch.Tensor, d: Down, w: torch.Tensor) -> torch.Tensor:
    """out[f] = x[coarse(f)] @ w[parity(f)] over the fine sites of d."""
    out = x.new_zeros((len(d.parity), w.shape[2]))
    for o in range(8):
        sel = torch.nonzero(d.parity == o).squeeze(1)
        out = out.index_copy(0, sel, x.index_select(0, d.fine_to_coarse[sel]) @ w[o])
    return out
