"""BLT/NCLT dataset files on the host (counterpart of sps_tpu/data/blt.py,
numpy only).

The on-disk layout: sequences under $DATA/sequence/<SEQ>/{scans,poses,
map_transform}, the base map under $DATA/maps/. Scans are .npy (N, 4)
float32 [x, y, z, label] in the sensor frame; a scan's ground-truth pose is
map_transform @ pose. load_sequences and BLTDataModule give the offline
predict path its scans posed into the map frame and padded to SCAN_POINTS;
`prefetched` pads the trainer's next batch on a worker thread.
"""

from __future__ import annotations

import os
import queue
import threading

import numpy as np


def _load_npy_f32(path: str) -> np.ndarray:
    return np.ascontiguousarray(np.load(path), dtype=np.float32)


def _pose(path: str) -> np.ndarray:
    return np.loadtxt(path, delimiter=",")


class SequenceData:
    """Scans of one split in the map frame, as host numpy arrays."""

    def __init__(self, scans: list[np.ndarray]):
        self.scans = scans  # each (N_i, 4): [x, y, z, label], map frame

    def __len__(self):
        return len(self.scans)


def _apply(tr: np.ndarray, pts: np.ndarray) -> np.ndarray:
    return pts @ tr[:3, :3].T + tr[:3, 3]


def load_sequences(root: str, seqs) -> SequenceData:
    """Every scan of `seqs`, posed (pose, then map_transform) into the map
    frame in float64 and stored as float32."""
    scans = []
    for seq in seqs:
        sdir = os.path.join(root, "sequence", seq)
        names = sorted(os.listdir(os.path.join(sdir, "scans")))
        pnames = sorted(os.listdir(os.path.join(sdir, "poses")))
        if len(names) != len(pnames):
            raise ValueError(f"scan/pose count mismatch in {seq}")
        map_tr = _pose(os.path.join(sdir, "map_transform"))
        for sn, pn in zip(names, pnames):
            scan = _load_npy_f32(os.path.join(sdir, "scans", sn))
            pose = _pose(os.path.join(sdir, "poses", pn))
            scan[:, :3] = _apply(map_tr, _apply(pose, scan[:, :3]))
            scans.append(scan)
    return SequenceData(scans)


def load_sequences_raw(root: str, seqs) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """Sensor-frame scans and ground-truth poses (map_transform @ pose), for
    localization, where the pose is estimated rather than given."""
    scans, poses = [], []
    for seq in seqs:
        sdir = os.path.join(root, "sequence", seq)
        names = sorted(os.listdir(os.path.join(sdir, "scans")))
        pnames = sorted(os.listdir(os.path.join(sdir, "poses")))
        map_tr = _pose(os.path.join(sdir, "map_transform"))
        for sn, pn in zip(names, pnames):
            scans.append(_load_npy_f32(os.path.join(sdir, "scans", sn)))
            poses.append(map_tr @ _pose(os.path.join(sdir, "poses", pn)))
    return scans, poses


def sequence_files(root: str, seq: str) -> tuple[list[str], list[np.ndarray]]:
    """Scan file paths and composed float32 poses per scan, without loading
    the scans."""
    sdir = os.path.join(root, "sequence", seq)
    scan_dir = os.path.join(sdir, "scans")
    pose_dir = os.path.join(sdir, "poses")
    names = sorted(os.listdir(scan_dir))
    pnames = sorted(os.listdir(pose_dir))
    assert len(names) == len(pnames), f"scan/pose count mismatch in {seq}"
    map_tr = _pose(os.path.join(sdir, "map_transform"))
    paths = [os.path.join(scan_dir, sn) for sn in names]
    poses = [(map_tr @ _pose(os.path.join(pose_dir, pn))).astype(np.float32) for pn in pnames]
    return paths, poses


def load_map(root: str, map_file: str) -> np.ndarray:
    """(M, 3) float32 map points (labels, if present, are dropped)."""
    path = os.path.join(root, "maps", map_file)
    arr = _load_npy_f32(path) if path.endswith(".npy") else np.loadtxt(path, dtype=np.float32)
    return np.ascontiguousarray(arr[:, :3], dtype=np.float32)


class BLTDataModule:
    """A split's scans and the map, batched into padded host arrays."""

    def __init__(self, cfg, test: bool = False):
        self.cfg = cfg
        root = cfg.data.root
        if not root:
            raise ValueError("dataset root not set ($DATA or --data)")
        self.map_points = load_map(root, cfg.data.map_file)
        if test:
            self.test = load_sequences(root, cfg.data.test)
        else:
            self.train = load_sequences(root, cfg.data.train)
            self.val = load_sequences(root, cfg.data.val)

    def batches(self, data: SequenceData, batch_size: int, shuffle: bool, seed: int = 0):
        """Yield dicts of (B, SCAN_POINTS, ...) padded arrays (the last batch
        padded with empty samples, so shapes never change) and the scans'
        indices."""
        ns = self.cfg.tpu.scan_points
        idx = np.arange(len(data))
        if shuffle:
            np.random.default_rng(seed).shuffle(idx)
        for i in range(0, len(idx), batch_size):
            sel = idx[i : i + batch_size]
            xyz = np.zeros((batch_size, ns, 3), np.float32)
            label = np.zeros((batch_size, ns), np.float32)
            valid = np.zeros((batch_size, ns), bool)
            for b, j in enumerate(sel):
                scan = data.scans[j]
                if len(scan) > ns:
                    raise ValueError(f"scan {j} has {len(scan)} points > capacity {ns}; "
                                     "raise TPU.SCAN_POINTS")
                n = len(scan)
                xyz[b, :n] = scan[:, :3]
                label[b, :n] = scan[:, 3]
                valid[b, :n] = True
            yield {"xyz": xyz, "label": label, "valid": valid, "indices": sel}


def prefetched(it):
    """Iterate `it` through a worker thread and a queue of at most two
    items, so the host pads batch i + 1 while the device runs step i. An
    exception of `it` is raised here, at its place in the sequence."""
    q: queue.Queue = queue.Queue(maxsize=2)
    stop = object()

    def worker():
        try:
            for item in it:
                q.put((item, None))
        except Exception as e:  # handed to the consumer, raised there
            q.put((None, e))
        finally:
            q.put((stop, None))

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item, err = q.get()
        if err is not None:
            raise err
        if item is stop:
            break
        yield item
    t.join(timeout=60)
