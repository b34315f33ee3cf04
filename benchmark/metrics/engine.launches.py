"""CUDA kernel launches per traced scan (copies and fills not counted)."""


def read(r):
    if r.launches <= 0:
        return None
    return r.launches / r.steps
