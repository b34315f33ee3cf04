"""Device time of the kernels launched under "sps.model" (MinkUNet,
devoxelize, sigmoid), per traced scan (ms)."""


def read(r):
    g = r.ranges.get("sps.model")
    if not g or g["device_s"] <= 0:
        return None
    return 1e3 * g["device_s"] / r.steps
