"""Training loop: Adam with a staircase LR decay, masked MSE (counterpart of
sps_tpu/train.py).

The reference's stack (Lightning, Adam(lr, weight_decay) with StepLR):
  * torch.optim.Adam(lr, betas (0.9, 0.999), eps 1e-8, weight_decay): its
    coupled L2 on every parameter is sps_tpu's optax chain
    add_decayed_weights -> adam; BN running statistics are buffers, not
    parameters, so they take no decay;
  * the LR is LR * LR_DECAY ** floor(step / (steps_per_epoch * LR_EPOCH)),
    stepped once per optimizer step (optax's staircase exponential_decay);
  * the loss is the MSE over scan points, or with STABLE_WEIGHT != 1 or
    LOSS bce the weighted per-point loss; R2 is logged;
  * checkpoints: `best` (lowest validation loss) and the resumable `last`
    (sps_torch/utils/checkpoint.py), JSONL logs and tensorboardX when it
    is installed.

A step (`train_step`) is the submap join, the augmentation, the forward in
train mode, the backward and the update, all on the device; it returns its
metrics as 0-d device tensors, which the loop reads on logged steps only.
The split lives on the device when it takes less than DEVICE_SPLIT_BYTES.
Training runs on the card unless device="cpu" is passed.

Data-parallel training (fit(devices=N), parallel/mesh.py): N ranks, one a
card (NCCL) or N CPU processes (gloo), launched by torchrun or spawned by
fit; each rank trains on its block of every batch, and grad_step averages
the gradients, the BN running statistics and the metrics over "dp", so the
replicated parameters stay equal.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from sps_torch import pipeline
from sps_torch import register as reg
from sps_torch.config import Config
from sps_torch.data.blt import BLTDataModule, prefetched
from sps_torch.models.spsnet import SPSModel
from sps_torch.parallel import comm
from sps_torch.parallel import spatial as sp_mod
from sps_torch.structs import resolve_device
from sps_torch.utils import checkpoint as ckpt
from sps_torch.utils.metrics import masked_mse, masked_r2

# A split smaller than this (scan_points * 17 bytes a scan) is kept on the
# device and batched by on-device gathers; a larger one is padded on the
# host, a batch ahead on a worker thread, and uploaded each step.
DEVICE_SPLIT_BYTES = 2 << 30


@dataclasses.dataclass
class TrainState:
    """The model (in train mode), its optimizer and LR schedule, and the
    number of optimizer steps taken."""

    model: SPSModel
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0


def create_state(cfg: Config, seed: int, steps_per_epoch: int, device=None,
                 sp_axis: str | None = None) -> TrainState:
    """A seeded model (He-normal kernels, BN statistics at 0 / 1, as a flax
    init), Adam and the staircase schedule, on `device` (default the card).
    sp_axis: the model runs spatially sharded over that mesh axis (the same
    parameters)."""
    dev = resolve_device(device)
    scfg = cfg.sps_config()
    if sp_axis is not None:
        scfg = sp_mod.sp_config(scfg, sp_axis)
    model = SPSModel(scfg, generator=torch.Generator().manual_seed(seed)).to(dev)
    model.train()
    tc = cfg.train
    opt = torch.optim.Adam(model.parameters(), lr=tc.lr, betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=tc.weight_decay)
    every = max(1, steps_per_epoch * tc.lr_epoch)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda s: tc.lr_decay ** (s // every))
    return TrainState(model, opt, sched)


def loss_of(scores, label, scan_mask, cfg: Config):
    """The training loss over scan points. With STABLE_WEIGHT != 1 or LOSS
    bce: stable points (label < 0.5) weigh STABLE_WEIGHT and the loss is
    the weighted mean of the squared error, or of the binary cross-entropy
    of the scores clipped to [1e-6, 1 - 1e-6]; otherwise the masked MSE
    (the reference loss). An unknown LOSS takes the squared error."""
    tc = cfg.train
    if tc.stable_weight != 1.0 or tc.loss == "bce":
        w = scan_mask.to(scores.dtype) * torch.where(label < 0.5, tc.stable_weight, 1.0)
        if tc.loss == "bce":
            s = torch.clamp(scores, 1e-6, 1.0 - 1e-6)
            per = -(label * torch.log(s) + (1.0 - label) * torch.log(1.0 - s))
        else:
            per = (scores - label) ** 2
        return (w * per).sum() / torch.clamp_min(w.sum(), 1.0)
    return masked_mse(scores, label, scan_mask)


def _all_reduce_flat(tensors, reduce) -> None:
    """reduce(one flat f32 buffer of every tensor), copied back in place."""
    flat = reduce(torch.cat([t.reshape(-1).float() for t in tensors]))
    i = 0
    for t in tensors:
        t.copy_(flat[i : i + t.numel()].view_as(t))
        i += t.numel()


def grad_step(state: TrainState, batch: dict, map_points, rng=None, map_vm=None, *,
              cfg: Config, augment: bool, axis_name: str | None = None,
              sp_axis: str | None = None) -> dict:
    """One optimizer step (sps_tpu's grad_step): the submap join, the
    augmentation (rng, a torch.Generator, when `augment`), the forward in
    train mode, the loss, the backward and the Adam update. The step's
    gradients stay in the parameters' .grad. Returns the metrics loss, r2,
    overflow and submap_overflow as 0-d device tensors.

    axis_name (data parallel): the gradients, the BN running statistics and
    the float metrics are averaged over that mesh axis and the flags OR'd,
    each in one flat all-reduce, so every rank applies the same update.
    sp_axis (spatial): the state's model must run sharded over it
    (create_state(..., sp_axis)); the weight gradients are summed over it
    first. As in sps_tpu, the loss of the replicated scores reaches each
    rank's block through the all-gather's transpose, a reduce-scatter of n
    equal cotangents, so the summed gradient is n_sp times the unsharded
    one (the BN statistics and the loss are not scaled)."""
    pb, aux = pipeline.assemble_batch(batch["xyz"], batch["label"], batch["valid"], map_points,
                                      cfg, rng if augment else None, map_vm=map_vm)
    model = state.model
    if model.cfg.unet.sp_axis != sp_axis:
        raise ValueError(f"the model runs sharded over {model.cfg.unet.sp_axis!r}, the step "
                         f"over {sp_axis!r}: build the state with create_state(..., sp_axis)")
    model.train()
    state.optimizer.zero_grad(set_to_none=True)
    scores, maux = model(pb)
    scan_mask = pb.valid & (pb.t == pipeline.SCAN_T)
    loss = loss_of(scores, pb.label, scan_mask, cfg)
    loss.backward()
    scores = scores.detach()
    metrics = {"loss": loss.detach(), "r2": masked_r2(scores, pb.label, scan_mask),
               "overflow": maux["overflow"].any(), "submap_overflow": aux["submap_overflow"]}
    if sp_axis is not None or axis_name is not None:
        with torch.no_grad():
            params = list(model.parameters())
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            grads = [p.grad for p in params]
            if sp_axis is not None:
                _all_reduce_flat(grads, lambda x: comm.psum(x, sp_axis))
            if axis_name is not None:
                _all_reduce_flat(grads, lambda x: comm.pmean(x, axis_name))
                _all_reduce_flat(list(model.buffers()), lambda x: comm.pmean(x, axis_name))
                names = sorted(metrics)
                fl = [k for k in names if metrics[k].dtype != torch.bool]
                vals = comm.pmean(torch.stack([metrics[k].float() for k in fl]), axis_name)
                flags = comm.pmax(torch.stack([metrics[k].to(torch.int32) for k in names
                                               if k not in fl]), axis_name) > 0
                metrics.update(zip(fl, vals))
                metrics.update(zip([k for k in names if k not in fl], flags))
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1
    return metrics


def train_step(state: TrainState, batch: dict, map_points, rng=None, map_vm=None, *,
               cfg: Config, augment: bool) -> dict:
    """One optimizer step on one device (grad_step without mesh axes)."""
    return grad_step(state, batch, map_points, rng, map_vm, cfg=cfg, augment=augment)


def eval_step(state: TrainState, batch: dict, map_points, map_vm=None, *, cfg: Config) -> dict:
    """Validation loss and r2 of one batch in eval mode (running statistics),
    as 0-d device tensors; the model returns to train mode."""
    pb, _ = pipeline.assemble_batch(batch["xyz"], batch["label"], batch["valid"], map_points,
                                    cfg, map_vm=map_vm)
    model = state.model
    model.eval()
    try:
        with torch.no_grad():
            scores, _ = model(pb)
    finally:
        model.train()
    scan_mask = pb.valid & (pb.t == pipeline.SCAN_T)
    return {"loss": masked_mse(scores, pb.label, scan_mask),
            "r2": masked_r2(scores, pb.label, scan_mask)}


class JSONLLogger:
    """<log_dir>/<name>.jsonl, one JSON object a call; tensorboard scalars too
    when tensorboardX is installed."""

    def __init__(self, log_dir: str, name: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{name}.jsonl")
        self.tb = None
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            return
        self.tb = SummaryWriter(os.path.join(log_dir, name))

    def log(self, step: int, **kv):
        with open(self.path, "a") as f:
            f.write(json.dumps({"step": step, **kv}) + "\n")
        if self.tb is not None:
            for k, v in kv.items():
                if isinstance(v, (int, float)):
                    self.tb.add_scalar(k, v, step)


def _device_split(split, scan_points: int, device) -> dict:
    """A split's scans padded to scan_points, as (n, ...) device tensors."""
    n = len(split.scans)
    xyz = np.zeros((n, scan_points, 3), np.float32)
    label = np.zeros((n, scan_points), np.float32)
    valid = np.zeros((n, scan_points), bool)
    for i, scan in enumerate(split.scans):
        if len(scan) > scan_points:
            raise ValueError(f"scan {i} has {len(scan)} points > capacity {scan_points}")
        k = len(scan)
        xyz[i, :k], label[i, :k], valid[i, :k] = scan[:, :3], scan[:, 3], True
    return {k: torch.as_tensor(v, device=device)
            for k, v in (("xyz", xyz), ("label", label), ("valid", valid))}


def fit(cfg: Config, log_dir: str = "./tb_logs", ckpt_dir: str = "./checkpoints",
        max_steps: int | None = None, seed: int = 0, resume: bool = False,
        devices: int = 1, device=None) -> str:
    """Train per config; returns the path of the best checkpoint (of `last`
    when max_steps ends the run).

    Epoch e visits the split in numpy's default_rng(seed + e) order (as
    sps_tpu's), the last batch padded with empty samples; validation drops
    a ragged tail and pads a split smaller than a batch. resume continues
    from <ckpt_dir>/last.pt: weights, BN statistics, optimizer and schedule
    state, step and epoch; a save that interrupted an epoch (max_steps)
    replays that epoch. Runs on the card unless device="cpu".

    devices > 1 trains data-parallel over that many ranks: cards (NCCL, one
    a rank) or, with device="cpu", CPU processes (gloo). batch_size must be
    divisible by devices, and fewer devices than asked raise. Under torchrun
    (RANK and WORLD_SIZE set) this process is one rank of `devices`;
    otherwise fit spawns the ranks and returns rank 0's path. Rank r draws
    its augmentation from seed + r; rank 0 logs and writes checkpoints."""
    if devices > 1:
        return _fit_dp(cfg, log_dir, ckpt_dir, max_steps, seed, resume, devices, device)
    return _fit(cfg, log_dir, ckpt_dir, max_steps, seed, resume, device)


def _fit_dp(cfg, log_dir, ckpt_dir, max_steps, seed, resume, devices, device):
    """fit's data-parallel launch (sps_tpu's contract: the batch divides over
    the devices, and a smaller mesh is an error, not a silent change)."""
    from sps_torch.parallel import launch

    if cfg.train.batch_size % devices:
        raise ValueError(f"batch_size {cfg.train.batch_size} not divisible by devices {devices}")
    if cfg.dist_feature:
        raise ValueError("dist_feature under dp training is not plumbed yet (as in sps_tpu); "
                         "train on one device or turn MODEL.DIST_FEATURE off")
    cpu = device is not None and torch.device(device).type == "cpu"
    have = (os.cpu_count() or 1) if cpu else torch.cuda.device_count()
    if devices > have:
        raise ValueError(f"--devices {devices} > {have} available "
                         f"({'CPU cores' if cpu else 'cards'}); a smaller mesh would silently "
                         "change parallelism")
    args = (cfg, log_dir, ckpt_dir, max_steps, seed, resume, cpu)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        world = int(os.environ["WORLD_SIZE"])
        if world != devices:
            raise ValueError(f"torchrun started {world} ranks for --devices {devices}")
        torch.distributed.init_process_group("gloo" if cpu else "nccl")
        try:
            return _fit_rank(int(os.environ["RANK"]), world, *args)
        finally:
            torch.distributed.destroy_process_group()
    return launch.spawn(_fit_rank, devices, *args, backend="gloo" if cpu else "nccl",
                        timeout=7 * 24 * 3600.0)[0]


def _fit_rank(rank, world, cfg, log_dir, ckpt_dir, max_steps, seed, resume, cpu):
    """One rank of data-parallel fit."""
    from sps_torch.parallel import mesh as pmesh

    if not cpu:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    mesh = pmesh.make_mesh(world, "dp")
    return _fit(cfg, log_dir, ckpt_dir, max_steps, seed, resume, "cpu" if cpu else None,
                mesh=mesh, rank=rank)


def _fit(cfg, log_dir, ckpt_dir, max_steps, seed, resume, device, mesh=None, rank=0):
    """fit's loop; with a dp mesh, this rank's part of it."""
    from sps_torch.parallel import mesh as pmesh

    dev = resolve_device(device)
    data = BLTDataModule(cfg)
    map_points = torch.as_tensor(data.map_points, device=dev)
    map_vm = None
    if cfg.dist_feature:
        # 4x voxel cells: the 27-cell search resolves distances past dist_cap.
        map_vm = reg.build_voxel_map(data.map_points, 4 * cfg.voxel_size, device=dev)
    bsz = cfg.train.batch_size
    steps_per_epoch = max(1, len(data.train) // bsz)
    state = create_state(cfg, seed, steps_per_epoch, dev)
    rng = torch.Generator(device=dev).manual_seed(seed + rank)
    main = rank == 0
    logger = JSONLLogger(log_dir, cfg.experiment_id) if main else None
    if mesh is None:
        def step_fn(hb):
            return train_step(state, hb, map_points, rng, map_vm, cfg=cfg,
                              augment=cfg.train.augmentation)
    else:
        dp_step = pmesh.make_dp_train_step(cfg, mesh, augment=cfg.train.augmentation)

        def step_fn(hb):
            return dp_step(state, hb, map_points, rng, map_vm)

    ns = cfg.tpu.scan_points
    device_data = (len(data.train) + len(data.val)) * ns * 17 < DEVICE_SPLIT_BYTES
    if device_data:
        train_dev = _device_split(data.train, ns, dev)
        val_dev = _device_split(data.val, ns, dev)

    best_val = float("inf")
    best_path = os.path.join(os.path.abspath(ckpt_dir), "best.pt")
    last_path = os.path.join(os.path.abspath(ckpt_dir), "last.pt")
    start_epoch = 0
    if resume:
        if not os.path.isfile(last_path):
            raise FileNotFoundError(
                f"--resume given but no last checkpoint at {last_path} "
                "(check --ckpt-dir); refusing to silently train from scratch")
        out = ckpt.restore(last_path, map_location=dev)
        if "optimizer" not in out:
            raise ValueError(f"{last_path} has no optimizer state; it is not a resumable "
                             "checkpoint and cannot seed --resume")
        state.model.load_state_dict(out["model"])
        state.optimizer.load_state_dict(out["optimizer"])
        state.scheduler.load_state_dict(out["scheduler"])
        state.step = int(out["step"])
        best_val = float(out.get("best_val", float("inf")))
        mid_epoch = bool(out.get("mid_epoch", False))
        # An end-of-epoch save resumes at the next epoch; a mid-epoch
        # (max_steps) save re-enters the interrupted epoch, whose batches
        # replay in the same seeded order.
        start_epoch = int(out["epoch"]) + (0 if mid_epoch else 1)
        if main:
            print(f"resumed from {last_path}: epoch {start_epoch}, step {state.step}, "
                  f"best_val {best_val:.4f}"
                  + (" (mid-epoch save: interrupted epoch replays)" if mid_epoch else ""),
                  flush=True)

    def save_last(epoch, mid_epoch=False):
        if main:
            ckpt.save(last_path, state.model, cfg, step=state.step, optimizer=state.optimizer,
                      scheduler=state.scheduler, epoch=epoch, full=True, best_val=best_val,
                      mid_epoch=mid_epoch)

    def epoch_batches(epoch):
        if device_data:
            n = train_dev["xyz"].shape[0]
            idx = np.arange(n)
            if cfg.data.shuffle:
                np.random.default_rng(seed + epoch).shuffle(idx)
            for i in range(0, n, bsz):
                sel = idx[i : i + bsz]
                k = len(sel)
                pick = torch.as_tensor(np.pad(sel, (0, bsz - k)), device=dev)
                hb = {name: v[pick] for name, v in train_dev.items()}
                if k < bsz:  # empty samples pad the tail batch
                    for v in hb.values():
                        v[k:] = 0
                yield hb
            return
        for batch in prefetched(data.batches(data.train, bsz, cfg.data.shuffle,
                                             seed=seed + epoch)):
            yield {k: torch.as_tensor(v, device=dev) for k, v in batch.items() if k != "indices"}

    def val_batches():
        if not device_data:
            for batch in data.batches(data.val, bsz, False):
                yield {k: torch.as_tensor(v, device=dev) for k, v in batch.items()
                       if k != "indices"}
            return
        n = val_dev["xyz"].shape[0]
        if n < bsz:  # a split smaller than one batch: pad with empty samples
            yield {k: torch.cat([v, torch.zeros_like(v)] * bsz)[:bsz] for k, v in val_dev.items()}
        for i in range(0, n - bsz + 1, bsz):  # drop the ragged tail
            yield {k: v[i : i + bsz] for k, v in val_dev.items()}

    t0 = time.time()
    first = state.step
    for epoch in range(start_epoch, cfg.train.max_epoch):
        for hb in epoch_batches(epoch):
            m = step_fn(hb)
            step = state.step
            if main and (step % 10 == 1 or max_steps):
                mm = {k: float(v) for k, v in m.items()}
                logger.log(step, epoch=epoch, **{f"train_{k}": v for k, v in mm.items()})
                print(f"epoch {epoch} step {step} loss {mm['loss']:.4f} r2 {mm['r2']:.4f} "
                      f"({(time.time() - t0) / (step - first):.2f}s/it)", flush=True)
            if max_steps and step >= max_steps:
                save_last(epoch, mid_epoch=True)
                return last_path
        vals = [eval_step(state, hb, map_points, map_vm, cfg=cfg) for hb in val_batches()]
        vloss = float(torch.stack([v["loss"] for v in vals]).mean())
        vr2 = float(torch.stack([v["r2"] for v in vals]).mean())
        if main:
            logger.log(state.step, epoch=epoch, val_loss=vloss, val_r2=vr2)
            print(f"epoch {epoch} VAL loss {vloss:.4f} r2 {vr2:.4f}", flush=True)
        if vloss < best_val:
            best_val = vloss
            if main:
                ckpt.save(best_path, state.model, cfg, step=state.step)
        save_last(epoch)
    return best_path
