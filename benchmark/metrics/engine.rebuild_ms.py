"""Device time of the kernels launched under the engine's "sps.rebuild"
range, per rebuild scan (ms)."""


def read(r):
    g = r.ranges.get("sps.rebuild")
    if not g or not g["count"] or g["device_s"] <= 0:
        return None
    return 1e3 * g["device_s"] / g["count"]
