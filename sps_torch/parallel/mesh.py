"""Multi-device layouts and the data-parallel training step (counterpart of
sps_tpu/parallel/mesh.py).

A mesh is a grid of the default process group's ranks, dp-major as sps_tpu's
Mesh(devices.reshape(n_dp, n_sp), ("dp", "sp")): rank r sits at (r // n_sp,
r % n_sp). Each axis gets one process group per line of the grid, and every
rank registers the group of its own line under the axis name
(parallel/comm.py), which the collectives of the model and the step take.

  * "dp": each rank runs the whole per-sample pipeline (join, voxelize,
    topology, MinkUNet, loss) on its block of the batch; gradients are
    averaged over dp, so every rank applies the same update to replicated
    parameters, optimizer state and map.
  * "sp" (optional second axis): each sample's brick / row axis is split
    over the ranks of a dp line (parallel/spatial.py); weight gradients are
    summed over sp before dp's mean.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from sps_torch.parallel import comm


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: tuple
    shape: tuple

    def size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]


def make_mesh(n_devices: int | None = None, axis="dp", shape: tuple | None = None) -> Mesh:
    """A mesh over the first n_devices ranks (all by default) of the default
    group: one axis named `axis`, or with `axis` a tuple of names and
    `shape` their sizes (product n_devices), the dp-major grid. Every rank
    of the default group must call it (new_group is collective); ranks
    outside the mesh register nothing."""
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n > world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}")
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    shape = (n,) if shape is None else tuple(shape)
    if len(shape) != len(names) or int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} for axes {names} and {n} ranks")
    grid = np.arange(n).reshape(shape)
    me = dist.get_rank()
    for k, name in enumerate(names):
        lines = np.moveaxis(grid, k, -1).reshape(-1, shape[k])
        for line in lines:
            g = dist.new_group([int(r) for r in line])
            if me in line:
                comm.register(name, g)
    return Mesh(names, shape)


def make_dp_train_step(cfg, mesh: Mesh, augment: bool = True):
    """The data-parallel training step: step(state, batch, map_points, rng,
    map_vm=None) -> metrics. `batch` is the whole host batch (B, ...), the
    same on every rank, B divisible by the dp size; each rank takes its
    block, runs train.grad_step with the dp reductions (and, with an "sp"
    axis, the sp ones: the state's model must then be built with sp_axis
    "sp", train.create_state(..., sp_axis="sp")). rng: this rank's
    torch.Generator for the augmentation, in the same state on the sp ranks
    of a dp line (they shard one sample; sps_tpu hands a line one key)."""
    from sps_torch import train as tr

    sp_axis = "sp" if "sp" in mesh.axis_names else None
    n_dp = mesh.size("dp")

    def step(state, batch, map_points, rng=None, map_vm=None):
        b = batch["xyz"].shape[0]
        if b % n_dp:
            raise ValueError(f"batch {b} not divisible by the dp size {n_dp}")
        r, k = comm.rank("dp"), b // n_dp
        local = {name: v[r * k : (r + 1) * k] for name, v in batch.items()}
        return tr.grad_step(state, local, map_points, rng, map_vm, cfg=cfg, augment=augment,
                            axis_name="dp", sp_axis=sp_axis)

    return step


def dryrun_config():
    """The flagship single-card configuration (atlas engine, brick side 8,
    halo convs, row levels from L3) at tiny capacities, f32, as sps_tpu's
    dry run."""
    from sps_torch.config import Config, DataConfig, TPUConfig, TrainConfig

    return Config(
        data=DataConfig(root="/tmp"),
        train=TrainConfig(batch_size=1, lr=1e-3),
        tpu=TPUConfig(scan_points=256, submap_points=256, cell_capacity=1024,
                      voxels=(1024, 512, 256, 256, 256), bricks=(512, 256, 256, 256, 256),
                      engine="atlas", brick_side=8, atlas_extent=(24, 24, 24),
                      conv_mode="halo", row_from=3),
    )


def dryrun(n_devices: int, device=None) -> dict:
    """One training step on an n_devices mesh (dp x sp = 2 x n/2 when n is
    even and at least 4, else dp n), then one sp StreamingFilter scan over
    all n ranks. Every rank of an initialized default group of n ranks calls
    it; returns the loss, the filter's kept count, the mesh's axes and a
    digest of the trained state (the sum of its absolute values, f64), the
    same on every rank when the ranks stay replicated."""
    from sps_torch import train as tr
    from sps_torch.stream.engine import StreamingFilter

    cfg = dryrun_config()
    if n_devices >= 4 and n_devices % 2 == 0:
        n_dp, n_sp = 2, n_devices // 2
        mesh = make_mesh(n_devices, ("dp", "sp"), (n_dp, n_sp))
    else:
        n_dp = n_devices
        mesh = make_mesh(n_devices, "dp")
    sp_axis = "sp" if "sp" in mesh.axis_names else None
    state = tr.create_state(cfg, 0, steps_per_epoch=1, device=device, sp_axis=sp_axis)
    dev = next(state.model.parameters()).device
    rnp = np.random.default_rng(0)
    ns = cfg.tpu.scan_points
    batch = {
        "xyz": torch.as_tensor(rnp.uniform(-5, 5, (n_dp, ns, 3)).astype(np.float32), device=dev),
        "label": torch.as_tensor(rnp.uniform(0, 1, (n_dp, ns)).astype(np.float32), device=dev),
        "valid": torch.ones((n_dp, ns), dtype=torch.bool, device=dev),
    }
    map_points = rnp.uniform(-5, 5, (4096, 3)).astype(np.float32)
    # One augmentation stream a dp line: its sp ranks shard the same sample.
    rng = torch.Generator(device=dev).manual_seed(1 + comm.rank("dp"))
    step = make_dp_train_step(cfg, mesh, augment=True)
    m = step(state, batch, torch.as_tensor(map_points, device=dev), rng)
    loss = float(m["loss"])
    if not np.isfinite(loss):
        raise AssertionError("non-finite loss in the multi-device dry run")

    filt = StreamingFilter(cfg, state.model.state_dict(), map_points, device=dev,
                           mesh=make_mesh(n_devices, "sp"))
    scores, keep, stats = filt(batch["xyz"][0].cpu().numpy(), batch["valid"][0].cpu().numpy(),
                               batch["label"][0].cpu().numpy(), np.eye(4, dtype=np.float32))
    if not bool(torch.isfinite(scores).all()):
        raise AssertionError("non-finite scores in the sp streaming dry run")
    digest = float(sum(v.double().abs().sum() for v in state.model.state_dict().values()))
    return {"loss": loss, "kept": int(stats["n_kept"]), "digest": digest,
            "axes": dict(zip(mesh.axis_names, mesh.shape))}
