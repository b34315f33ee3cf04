"""Share of the traced wall time in which no operation ran on the device
(%), over the filter's scans."""


def read(r):
    if r.busy_s <= 0 or r.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)
