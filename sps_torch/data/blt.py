"""BLT/NCLT dataset files on the host (counterpart of sps_tpu/data/blt.py,
numpy only).

The on-disk layout: sequences under $DATA/sequence/<SEQ>/{scans,poses,
map_transform}, the base map under $DATA/maps/. Scans are .npy (N, 4)
float32 [x, y, z, label] in the sensor frame; a scan's ground-truth pose is
map_transform @ pose.
"""

from __future__ import annotations

import os

import numpy as np


def _load_npy_f32(path: str) -> np.ndarray:
    return np.ascontiguousarray(np.load(path), dtype=np.float32)


def _pose(path: str) -> np.ndarray:
    return np.loadtxt(path, delimiter=",")


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
