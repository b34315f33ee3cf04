"""Range-image projection and azimuth windowing for the LTS filter
(counterpart of sps_tpu/data/range_image.py, numpy only).

Labelled points project into a (num_beams, 1024, 4) image per LiDAR model,
then the image splits into fixed azimuth windows that SPCTReg scores as
dense point batches. Three behaviours are the reference loader's and are
kept exactly: rows are deduplicated with np.unique (which sorts them),
rows labelled -1 are dropped, and out-of-FOV rows are clipped into the
image with last-write-wins (the azimuth index runs from -1024 to 1023, so
negative indices wrap).
"""

from __future__ import annotations

import numpy as np

LIDAR_PARAMS = {
    "vlp-16": {"num_beams": 16, "fov_up": 16.8, "fov_down": -16.8, "window_size": 128},
    "hdl-32": {"num_beams": 32, "fov_up": 30.0, "fov_down": -10.0, "window_size": 64},
}
NUM_SLICES = 1024


def project(data: np.ndarray, lidar: str = "vlp-16") -> np.ndarray:
    """(N, 4) [x, y, z, label] -> (num_beams, 1024, 4) range image."""
    p = LIDAR_PARAMS[lidar]
    data = np.unique(data, axis=0)
    data = data[data[:, 3] != -1]
    x, y, z = data[:, 0], data[:, 1], data[:, 2]
    theta = np.degrees(np.arctan2(z, np.sqrt(x**2 + y**2)))
    phi = np.degrees(np.arctan2(y, x))
    theta_res = (p["fov_up"] - p["fov_down"]) / (p["num_beams"] - 1)
    phi_res = 360.0 / NUM_SLICES
    ti = np.clip(np.floor((theta - p["fov_down"]) / theta_res).astype(np.int32), 0,
                 p["num_beams"] - 1)
    pi = np.clip(np.floor(phi / phi_res).astype(np.int32), -NUM_SLICES, NUM_SLICES - 1)
    img = np.zeros((p["num_beams"], NUM_SLICES, 4), np.float32)
    img[ti, pi] = data[:, :4]
    return img


def windows(img: np.ndarray, lidar: str = "vlp-16") -> tuple[np.ndarray, np.ndarray]:
    """(num_beams, 1024, 4) -> ((num_windows, num_beams * window, 3) points,
    (num_windows, num_beams * window) labels): one dense batch element per
    azimuth window."""
    p = LIDAR_PARAMS[lidar]
    w = p["window_size"]
    nw = NUM_SLICES // w
    pts, labels = [], []
    for i in range(nw):
        fr = img[:, i * w:(i + 1) * w, :].reshape(-1, 4)
        pts.append(fr[:, :3])
        labels.append(fr[:, 3])
    return np.stack(pts), np.stack(labels)
