"""The int8 brick conv's share of its roofline (%): the sum over its calls
of max(operations / int8 peak, bytes / HBM bandwidth), counted from the
occupied bricks by benchmark/work/brick_int8.py, over the summed device
time of the `brick_int8*` kernel events."""


def read(r):
    bound = r.work.get("int8_bound_s")
    t = sum(sec for name, (_, sec) in r.kernels.items() if "brick_int8" in name)
    if not bound or t <= 0:
        return None
    return 100.0 * bound / t
