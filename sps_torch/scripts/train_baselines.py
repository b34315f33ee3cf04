"""Train the baseline filters (MOS4D, MapMOS, LTS) on a dataset's train
split (the port of scripts/train_baselines.py, same CLI and defaults):

    python -m sps_torch.scripts.train_baselines -c config/config_loc.yaml --data DIR \\
        [--out ./checkpoints/baselines] [--models mos4d,mapmos,lts] [--steps 200] \\
        [--n-scans 4] [--points-per-scan 16384] [--map-points 32768] [--seed 0] \\
        [--device cpu]

  * MOS4D: a buffer of --n-scans consecutive scans in the world frame (the
    buffer index is the time slot), masked mean BCE on the moving logit
    (channel 2) against the stability labels; Adam 1e-3.
  * MapMOS: one scan (slot 1) against a 30 m map crop (slot 0), the
    normalized-index feature from the scan index (-1 on map points), the
    same BCE on the scan points only; Adam 1e-3.
  * LTS: the scan's range-image windows through SPCTReg with dropout,
    occupancy-masked MSE against the labels; Adam 5e-4.

The batches are numpy draws, in sps_tpu's order from the same generators
(default_rng(seed), seed + 1, seed + 2), so a seed gives both packages the
same batches. Adam's betas and eps are optax's; a parameter without a
gradient gets a zero one, because optax updates every leaf and torch's
Adam skips a None grad. Each model is written as <out>/<model>.pt
(sps_torch/utils/checkpoint.py, with its .config.json beside it), which
`run_localization(..., baseline_weights=<out>)` and
`python -m sps_torch.stream.localize --baseline-weights <out>` read.
Trains on the card unless --device cpu.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from sps_torch.data import range_image as ri
from sps_torch.models import lts, mos4d
from sps_torch.models.mapmos import MapMOSConfig, MapMOSNet
from sps_torch.models.mos4d import MOS4DConfig, MOS4DNet
from sps_torch.structs import Capacities, PointBatch, resolve_device
from sps_torch.utils import checkpoint

LR = {"mos4d": 1e-3, "mapmos": 1e-3, "lts": 5e-4}
ADAM = dict(betas=(0.9, 0.999), eps=1e-8)  # optax.adam's defaults
MAP_CROP = 30.0  # m, MapMOS's map crop around the scan's position
LOG_EVERY = 25
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(m):
    print(f"[{time.strftime('%H:%M:%S')}] {m}", flush=True)


def bce(logits, labels, mask):
    """The binary cross-entropy of logits as optax's
    sigmoid_binary_cross_entropy computes it, masked and averaged over
    max(sum(mask), 1): -z log sigmoid(x) - (1 - z) log sigmoid(-x), which
    is max(x, 0) - x z + log1p(exp(-|x|)) to rounding. Written as optax
    writes it, its gradient is sigmoid(x) - z everywhere; the max/abs form
    would take torch's subgradients at x = 0 (a point of an unkept slot has
    logit 0)."""
    per = -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)
    return (per * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def _subsample(rng, scan, n):
    if len(scan) <= n:
        return scan
    return scan[rng.choice(len(scan), n, replace=False)]


def mos4d_batches(scans, poses, n_scans, ns, seed):
    """The MOS4D trainer's batches (xyz, t, label, valid), numpy, drawn from
    default_rng(seed): n_scans consecutive scans from a random start, each
    subsampled to ns points and posed into the world frame."""
    rng = np.random.default_rng(seed)
    nt = n_scans * ns
    while True:
        s0 = rng.integers(0, len(scans) - n_scans)
        xyz = np.zeros((nt, 3), np.float32)
        t = np.zeros((nt,), np.int32)
        lab = np.zeros((nt,), np.float32)
        valid = np.zeros((nt,), bool)
        for i in range(n_scans):
            sc = _subsample(rng, scans[s0 + i], ns)
            w = sc[:, :3] @ poses[s0 + i][:3, :3].T + poses[s0 + i][:3, 3]
            k = len(sc)
            o = i * ns
            xyz[o : o + k], t[o : o + k] = w, i
            lab[o : o + k], valid[o : o + k] = sc[:, 3], True
        yield xyz, t, lab, valid


def mapmos_batches(scans, poses, map_points, ns, nm, seed):
    """The MapMOS trainer's batches (xyz, t, label, valid, sup, idx), numpy,
    drawn from default_rng(seed + 1): a random scan (ns points, slot 1,
    supervised) and a crop of the map within MAP_CROP of its position (nm
    points, slot 0); idx is the scan index on scan rows and -1 elsewhere.
    The first draw (scan 0) is the one sps_tpu initializes its model with:
    it is drawn and dropped, so the training batches follow it."""
    rng = np.random.default_rng(seed + 1)
    nt = ns + nm

    def sample(i=None):
        si = rng.integers(0, len(scans)) if i is None else i
        sc = _subsample(rng, scans[si], ns)
        w = sc[:, :3] @ poses[si][:3, :3].T + poses[si][:3, 3]
        center = poses[si][:3, 3]
        d = np.linalg.norm(map_points - center[None], axis=1)
        local = map_points[d < MAP_CROP]
        local = _subsample(rng, local, nm)
        xyz = np.zeros((nt, 3), np.float32)
        t = np.zeros((nt,), np.int32)
        lab = np.zeros((nt,), np.float32)
        valid = np.zeros((nt,), bool)
        sup = np.zeros((nt,), np.float32)
        k = len(sc)
        xyz[:k], t[:k], lab[:k], valid[:k], sup[:k] = w, 1, sc[:, 3], True, 1.0
        m = len(local)
        xyz[ns : ns + m], valid[ns : ns + m] = local, True
        idx = np.where(np.arange(nt) < ns, float(si), -1.0).astype(np.float32)
        return xyz, t, lab, valid, sup, idx

    sample(0)
    while True:
        yield sample()


def lts_batches(scans, seed):
    """The LTS trainer's batches (windows, labels), numpy, drawn from
    default_rng(seed + 2): a random scan's range-image windows. The first
    draw (sps_tpu's init input) is dropped."""
    rng = np.random.default_rng(seed + 2)

    def sample():
        sc = scans[rng.integers(0, len(scans))]
        img = ri.project(sc[:, :4], "vlp-16")
        wins, labels = ri.windows(img, "vlp-16")
        return wins.astype(np.float32), labels.astype(np.float32)

    sample()
    while True:
        yield sample()


def mos4d_config(cfg, n_scans) -> MOS4DConfig:
    return MOS4DConfig(voxel_size=cfg.voxel_size, n_scans=n_scans,
                       caps=cfg.sps_config(batch_size=1).caps)


def mapmos_config(cfg) -> MapMOSConfig:
    return MapMOSConfig(voxel_size=cfg.voxel_size, caps=cfg.sps_config(batch_size=1).caps)


def _point_batch(xyz, t, lab, valid, device) -> PointBatch:
    t = torch.as_tensor(t, device=device)
    return PointBatch(xyz=torch.as_tensor(xyz, device=device), batch=torch.zeros_like(t), t=t,
                      label=torch.as_tensor(lab, device=device),
                      valid=torch.as_tensor(valid, device=device))


def mos4d_loss(model, batch):
    """Masked mean BCE of MOS4D's moving logits on one batch (numpy)."""
    xyz, t, lab, valid = batch
    dev = next(model.parameters()).device
    pb = _point_batch(xyz, t, lab, valid, dev)
    logits, _ = model(pb)
    return bce(logits, pb.label, pb.valid.float())


def mapmos_loss(model, batch):
    """The same BCE of MapMOS's logits, on the scan points only."""
    xyz, t, lab, valid, sup, idx = batch
    dev = next(model.parameters()).device
    pb = _point_batch(xyz, t, lab, valid, dev)
    logits, _ = model(pb, torch.as_tensor(idx, device=dev))
    return bce(logits, pb.label, torch.as_tensor(sup, device=dev))


def lts_loss(model, batch, generator=None):
    """Mean squared error of SPCTReg's scores over the occupied window
    points; `generator` draws the dropout masks."""
    wins, labels = batch
    dev = next(model.parameters()).device
    wins = torch.as_tensor(wins, device=dev)
    labels = torch.as_tensor(labels, device=dev)
    scores = model(wins, generator)
    occ = (wins.abs().sum(-1) > 0).float()
    return (occ * (scores - labels) ** 2).sum() / torch.clamp_min(occ.sum(), 1.0)


def adam(model, name) -> torch.optim.Adam:
    return torch.optim.Adam(model.parameters(), lr=LR[name], **ADAM)


def train_step(model, opt, loss_fn) -> torch.Tensor:
    """One step of a train-mode model: loss_fn(), its gradients (zero for a
    parameter the loss does not reach, as optax takes it), Adam. Returns the
    loss, detached."""
    opt.zero_grad(set_to_none=True)
    loss = loss_fn()
    loss.backward()
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    opt.step()
    return loss.detach()


def _fit(name, model, loss_fn, batches, steps, cfg, out):
    """`steps` Adam steps of the train-mode model over `batches`; writes
    <out>/<name>.pt. Returns (its path, the losses as floats)."""
    opt = adam(model, name)
    model.train()
    losses = []
    for i in range(steps):
        batch = next(batches)
        loss = train_step(model, opt, lambda: loss_fn(model, batch))
        losses.append(loss)
        if i % LOG_EVERY == 0 or i == steps - 1:
            log(f"[{name}] step {i} loss {float(loss):.4f}")
    path = os.path.join(out, f"{name}.pt")
    model.eval()
    checkpoint.save(path, model, cfg, step=steps)
    return path, [float(x) for x in losses]


def train_mos4d(cfg, scans, poses, labels_available, steps, n_scans, ns, out, seed, device=None):
    """MOS4D on n_scans-scan buffers of ns points a scan (sps_tpu's
    signature; labels_available is unused there too); writes <out>/mos4d.pt."""
    dev = resolve_device(device)
    model = MOS4DNet(mos4d_config(cfg, n_scans), torch.Generator().manual_seed(seed)).to(dev)
    return _fit("mos4d", model, mos4d_loss, mos4d_batches(scans, poses, n_scans, ns, seed),
                steps, cfg, out)


def train_mapmos(cfg, scans, poses, map_points, steps, ns, nm, out, seed, device=None):
    """MapMOS on ns scan points against nm map points; writes <out>/mapmos.pt."""
    dev = resolve_device(device)
    model = MapMOSNet(mapmos_config(cfg), torch.Generator().manual_seed(seed)).to(dev)
    return _fit("mapmos", model, mapmos_loss,
                mapmos_batches(scans, poses, map_points, ns, nm, seed), steps, cfg, out)


def train_lts(cfg, scans, steps, out, seed, device=None):
    """SPCTReg (dropout 0.2, drawn from a generator seeded seed + 3 on the
    device) on range-image windows; writes <out>/lts.pt."""
    dev = resolve_device(device)
    model = lts.SPCTReg()
    model.load_state_dict(lts.init_state_dict(seed, random_stats=False))
    model.to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    return _fit("lts", model, lambda m, b: lts_loss(m, b, gen), lts_batches(scans, seed),
                steps, cfg, out)


# One step of a record of sps_torch/assets/baseline_train_pin.npz
# (scripts/export_torch_assets.py --only baseline_train; its "meta" entry is
# the `meta` below), as the port's trainers take it. The CPU tests and
# chip_smoke.py hold it against the pin and the card's step against the CPU's.
def pin_config(meta):
    """The pin's configuration: meta["config"] at meta's voxel size, whose
    sps_config carries meta's capacities."""
    from sps_torch import config as cfg_mod

    cfg = dataclasses.replace(cfg_mod.load(os.path.join(ROOT, meta["config"])),
                              voxel_size=meta["voxel_size"])
    caps = Capacities(points=meta["caps"]["points"], voxels=tuple(meta["caps"]["voxels"]),
                      bricks=tuple(meta["caps"]["bricks"]))

    class Pinned(type(cfg)):
        def sps_config(self, batch_size=None):
            return dataclasses.replace(super().sps_config(batch_size), caps=caps)

    return Pinned(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def pin_model(record, meta):
    """A pin record's model on the CPU as its trainer builds it from meta's
    seed (LTS at the pin's dropout), and its loss."""
    cfg, seed = pin_config(meta), meta["seed"]
    name = record.removesuffix("_f32")
    if name == "mos4d":
        return MOS4DNet(mos4d_config(cfg, meta["n_scans"]),
                        torch.Generator().manual_seed(seed)), mos4d_loss
    if name == "mapmos":
        return MapMOSNet(mapmos_config(cfg), torch.Generator().manual_seed(seed)), mapmos_loss
    model = lts.SPCTReg(dropout=meta["lts_dropout"])
    model.load_state_dict(lts.init_state_dict(seed, random_stats=False))
    return model, lts_loss


def pin_step(record, batch, meta, device):
    """One train step of a pin record's model on `device` from its seeded
    weights on `batch` (mos4d_f32: level 0's occupancy in f32, so MOS4D
    computes in f32). Returns {loss, init, grads, after}, the tensors on
    the CPU (init and after: state_dicts)."""
    model, loss_fn = pin_model(record, meta)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    model.to(device).train()
    real = mos4d.build_pyramid

    def f32_pyramid(pb, scfg):
        levels, p2s, overflow = real(pb, scfg)
        lv0 = levels[0]._replace(grid=levels[0].grid._replace(occ=levels[0].grid.occ.float()))
        return [lv0, *levels[1:]], p2s, overflow

    mos4d.build_pyramid = f32_pyramid if record == "mos4d_f32" else real
    try:
        loss = train_step(model, adam(model, record.removesuffix("_f32")),
                          lambda: loss_fn(model, batch))
    finally:
        mos4d.build_pyramid = real
    return {"loss": float(loss), "init": init,
            "grads": {k: p.grad.detach().cpu() for k, p in model.named_parameters()},
            "after": {k: v.detach().cpu() for k, v in model.state_dict().items()}}


def main(argv=None):
    from sps_torch import config as cfg_mod
    from sps_torch.data import blt

    ap = argparse.ArgumentParser(description="Train the MOS4D, MapMOS and LTS baselines.")
    ap.add_argument("-c", "--config", default="./config/config_loc.yaml")
    ap.add_argument("--data", default=None, help="dataset root (defaults to $DATA)")
    ap.add_argument("--out", default="./checkpoints/baselines")
    ap.add_argument("--models", default="mos4d,mapmos,lts")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--n-scans", type=int, default=4, help="MOS4D buffer length")
    ap.add_argument("--points-per-scan", type=int, default=16384)
    ap.add_argument("--map-points", dest="nm", type=int, default=32768)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' for the CPU")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    cfg = cfg_mod.load(args.config, data_root=args.data)
    scans, poses = blt.load_sequences_raw(cfg.data.root, cfg.data.train)
    map_pts = blt.load_map(cfg.data.root, cfg.data.map_file)
    os.makedirs(args.out, exist_ok=True)
    todo = [m.strip() for m in args.models.split(",")]
    if "mos4d" in todo:
        train_mos4d(cfg, scans, poses, True, args.steps, args.n_scans, args.points_per_scan,
                    args.out, args.seed, device=args.device)
    if "mapmos" in todo:
        train_mapmos(cfg, scans, poses, map_pts, args.steps, args.points_per_scan, args.nm,
                     args.out, args.seed, device=args.device)
    if "lts" in todo:
        train_lts(cfg, scans, args.steps, args.out, args.seed, device=args.device)
    log(f"baseline checkpoints in {args.out}")


if __name__ == "__main__":
    main()
