"""Operations of MinkUNet14 on a set of sites, with MinkowskiEngine's
semantics: for each conv, 2 * C_in * C_out * the (active output site,
active input site) pairs inside its kernel. The strided down convs pair
each finer site with its one coarse site, the transposed up convs each
finer site with its parent, 1 x 1 convs and the head each site with
itself. Counted from the inputs' sites, so no implementation can need
less."""

from __future__ import annotations

from benchmark.reference import minkunet as mk
from benchmark.reference import sparse as sp


def operations(pyr: mk.Pyramid, a: mk.Arch) -> int:
    n = [len(s) for s in pyr.levels]
    total = 2 * a.in_channels * a.init_dim * sp.pairs(pyr.stem)
    for i, (_, _, _, li, cin, cout, bcin, planes) in enumerate(mk.stages(a)):
        total += 2 * cin * cout * (n[li - 1] if i < 4 else n[li])
        p = sp.pairs(pyr.block[li])
        total += 2 * bcin * planes * p + 2 * planes * planes * p
        if bcin != planes:
            total += 2 * bcin * planes * n[li]
    return total + 2 * a.planes[7] * a.out_channels * n[0]
