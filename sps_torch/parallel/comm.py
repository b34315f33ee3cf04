"""Collectives over one process group per mesh axis (the port's counterpart
of the jax.lax collectives that sps_tpu's parallel code calls inside
shard_map).

`register(axis, group)` names a process group ("dp", "sp"); parallel/mesh.py
registers the groups of a mesh. Every collective takes the axis name, as
jax.lax's do, and is differentiable with JAX's transposes: the gradient of
the tiled all-gather is a reduce-scatter (an all-to-all of the gradient's
blocks, then their sum in rank order), of an all-reduce sum an all-reduce
sum, of an all-to-all the same all-to-all. They are autograd Functions over
torch.distributed's own collectives, not torch.distributed.nn.functional
(deprecated, its reduce-scatter on gloo emulated by the same all-to-all) or
the functional collectives (their autograd forms are private): the host
staging below has to sit inside each collective, between its forward and
backward.

Transport: gloo takes CUDA tensors for all-reduce and broadcast only, and
NCCL refuses two ranks on one card, so ranks that share a card use gloo
and every collective of a CUDA tensor on a gloo group copies it to the
host and back. That is chosen by
the group's backend, never as a reaction to a failure, and counted in
HOST_STAGED["copies"] (one a collective). On NCCL nothing is staged.

COLLECTIVES counts every collective this process enters, by kind, with
its output bytes (sps_tpu's convention for the collectives of its HLO,
scripts/measure_sp_scaling.py::_line_bytes): an all-gather's whole
gathered tensor, an all-to-all's and an all-reduce's tensor.
`reset_counts()` sets both counters to 0.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# Host round trips of CUDA tensors through gloo collectives.
HOST_STAGED = {"copies": 0}
# Collectives entered, by kind: {"count": calls, "bytes": output bytes}.
COLLECTIVES = {kind: {"count": 0, "bytes": 0}
               for kind in ("all-gather", "all-to-all", "all-reduce")}

_GROUPS: dict = {}


def register(axis: str, group) -> None:
    """Name the process group of a mesh axis (None: the default group)."""
    _GROUPS[axis] = group


def group(axis: str):
    if axis not in _GROUPS:
        raise ValueError(f"no process group for mesh axis {axis!r}: build the mesh first "
                         "(parallel.mesh.make_mesh)")
    return _GROUPS[axis]


def size(axis: str) -> int:
    return dist.get_world_size(group(axis))


def rank(axis: str) -> int:
    return dist.get_rank(group(axis))


def reset_counts() -> None:
    """Set HOST_STAGED and COLLECTIVES to 0."""
    HOST_STAGED["copies"] = 0
    for rec in COLLECTIVES.values():
        rec["count"] = rec["bytes"] = 0


def _counted(kind: str, out: torch.Tensor) -> torch.Tensor:
    rec = COLLECTIVES[kind]
    rec["count"] += 1
    rec["bytes"] += out.numel() * out.element_size()
    return out


def _host(x: torch.Tensor, g):
    """(tensor to hand the collective, whether to copy its result back)."""
    if x.is_cuda and dist.get_backend(g) == dist.Backend.GLOO:
        HOST_STAGED["copies"] += 1
        return x.detach().cpu(), True
    return x.detach().contiguous(), False


def _gather_raw(x: torch.Tensor, g) -> torch.Tensor:
    xs, back = _host(x, g)
    parts = [torch.empty_like(xs) for _ in range(dist.get_world_size(g))]
    dist.all_gather(parts, xs, group=g)
    out = _counted("all-gather", torch.cat(parts))
    return out.to(x.device) if back else out


def _all_to_all_raw(x: torch.Tensor, g) -> torch.Tensor:
    xs, back = _host(x, g)
    out = torch.empty_like(xs)
    dist.all_to_all_single(out, xs, group=g)
    _counted("all-to-all", out)
    return out.to(x.device) if back else out


def _reduce_raw(x: torch.Tensor, g, op=dist.ReduceOp.SUM) -> torch.Tensor:
    xs, back = _host(x, g)
    xs = xs.clone() if not back else xs
    dist.all_reduce(xs, op=op, group=g)
    _counted("all-reduce", xs)
    return xs.to(x.device) if back else xs


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _gather_raw(x, group(axis))

    @staticmethod
    def backward(ctx, gout):
        g = group(ctx.axis)
        n = dist.get_world_size(g)
        blocks = gout.reshape((n, gout.shape[0] // n) + tuple(gout.shape[1:]))
        return _all_to_all_raw(blocks, g).sum(0), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _all_to_all_raw(x, group(axis))

    @staticmethod
    def backward(ctx, gout):
        return _all_to_all_raw(gout, group(ctx.axis)), None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _reduce_raw(x, group(axis))

    @staticmethod
    def backward(ctx, gout):
        return _reduce_raw(gout, group(ctx.axis)), None


def all_gather(x: torch.Tensor, axis: str) -> torch.Tensor:
    """Rank blocks concatenated along dim 0 (jax.lax.all_gather(tiled=True))."""
    return _AllGather.apply(x, axis)


def all_to_all(x: torch.Tensor, axis: str) -> torch.Tensor:
    """x (n, ...): block j goes to rank j; returns (n, ...), block j from rank
    j (jax.lax.all_to_all with split_axis = concat_axis = 0)."""
    return _AllToAll.apply(x, axis)


def psum(x: torch.Tensor, axis: str) -> torch.Tensor:
    return _Psum.apply(x, axis)


def pmean(x: torch.Tensor, axis: str) -> torch.Tensor:
    return psum(x, axis) / size(axis)


def pmax(x: torch.Tensor, axis: str) -> torch.Tensor:
    """Elementwise max over the axis (no gradient)."""
    return _reduce_raw(x, group(axis), dist.ReduceOp.MAX)
