"""The int8 brick conv's least time per call, from the inputs.

The configuration runs each 3^4 block conv of the brick levels (below
ROW_FROM) as a dense 3^3 conv over bricks of side `bs`, time packed into
channels (T * C). For one call, counted over the bricks that hold at least
one site of that scan at that level (not the capacity, not phantom
bricks):
  operations = 2 * bricks * bs^3 * 27 * (T * Cin) * (T * Cout)
  bytes      = int8 input codes, each once (bricks * bs^3 * T * Cin)
             + the 27-neighbour table (bricks * 27 * 4)
             + int8 weight codes (27 * T * Cin * T * Cout) and f32 scales
             + the output (bricks * bs^3 * T * Cout * out_bytes)
and the bound is max(operations / int8 peak, bytes / HBM bandwidth)."""

from __future__ import annotations

import torch

from benchmark import peaks
from benchmark.reference import minkunet as mk


def occupied_bricks(pyr: mk.Pyramid, level: int, brick_side: int) -> int:
    c = pyr.levels[level].coords
    shift = brick_side.bit_length() - 1
    return len(torch.unique(c[:, 1:4] >> shift, dim=0))


def calls(a: mk.Arch, levels, num_time: int):
    """(level, T * Cin, T * Cout) of each int8 call."""
    out = []
    for _, _, _, li, _, _, bcin, planes in mk.stages(a):
        if li in levels:
            out.append((li, num_time * bcin, num_time * planes))
            out.append((li, num_time * planes, num_time * planes))
    return out


def bound_s(pyr: mk.Pyramid, a: mk.Arch, levels, brick_side: int, num_time: int,
            out_bytes: int) -> float:
    vol = brick_side ** 3
    nb = {li: occupied_bricks(pyr, li, brick_side) for li in set(levels)}
    total = 0.0
    for li, tci, tco in calls(a, levels, num_time):
        b = nb[li]
        ops = 2.0 * b * vol * 27 * tci * tco
        nbytes = b * vol * tci + b * 27 * 4 + 27 * tci * tco + 4 * tco + b * vol * tco * out_bytes
        total += max(ops / peaks.INT8_OPS, nbytes / peaks.HBM_BYTES_PER_S)
    return total
