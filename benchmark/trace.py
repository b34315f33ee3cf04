"""The traced stretch: torch.profiler over a few steps, reduced to a Reading.

The program's profiler ranges (`sps.*`) and the harness's own (`bench.*`)
give host ranges and, through key_averages, the device time of the kernels
launched inside each. The raw device events give the busy time (the union
of their intervals), the launches, the time by kernel name and the idle
gaps between them, each named by the innermost harness or program range
and the innermost host op open at its middle. Readers in
benchmark/metrics/ compute each per-layer metric from a Reading.
"""

from __future__ import annotations

import dataclasses
import time

from torch.profiler import ProfilerActivity, profile, record_function

RANGE_PREFIXES = ("sps.", "bench.")
NOT_KERNELS = ("Memcpy", "Memset", "memcpy", "memset")
TOP = 10
NAME_CHARS = 160  # of a kernel's name in the breakdown (templates run to 1,000s)


@dataclasses.dataclass
class Reading:
    steps: int  # traced scans or optimizer steps
    window_s: float  # host wall time of the traced steps
    busy_s: float  # union of the device operations' intervals
    launches: int  # device kernel events (copies and fills not counted)
    kernels: dict  # kernel name -> [count, seconds]
    ranges: dict  # range name -> {"count", "device_s", "host_s"}
    idle_gaps: list  # [[named gap, seconds]], longest first
    work: dict = dataclasses.field(default_factory=dict)  # counts from the inputs

    def device_ops(self) -> list:
        top = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:TOP]
        return [[name[:NAME_CHARS], sec] for name, (_, sec) in top]


def _device_s(evt, inclusive: bool) -> float:
    keys = (("device_time_total", "cuda_time_total") if inclusive
            else ("self_device_time_total", "self_cuda_time_total"))
    for key in keys:
        if hasattr(evt, key):
            return float(getattr(evt, key)) * 1e-6
    return 0.0


def _is_device(evt) -> bool:
    return str(evt.device_type()).endswith(("CUDA", "PrivateUse1"))


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _gap_name(mid, host_events) -> str:
    """Innermost harness/program range and innermost host op open at `mid`."""
    rng, op = None, None
    for e in host_events:
        s, d = e.start_ns(), e.duration_ns()
        if not s <= mid <= s + d:
            continue
        name = e.name()
        if name.startswith(RANGE_PREFIXES):
            if rng is None or d < rng[1]:
                rng = (name, d)
        elif op is None or d < op[1]:
            op = (name, d)
    parts = [p[0] for p in (rng, op) if p is not None]
    return " / ".join(parts) if parts else "host"


def traced(step, n: int, sync) -> Reading:
    """Profile step(i) for i < n, each under a "bench.step" range, with
    sync() before and at the end."""
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            with record_function("bench.step"):
                step(i)
        sync()
        wall = time.perf_counter() - t0
    ranges = {}
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA") or not e.key.startswith(
                RANGE_PREFIXES):
            continue
        ranges[e.key] = {"count": e.count, "device_s": _device_s(e, True),
                         "host_s": e.cpu_time_total * 1e-6}
    raw = prof.profiler.kineto_results.events()
    dev = [e for e in raw if _is_device(e) and not e.name().startswith(RANGE_PREFIXES)]
    host = [e for e in raw if not _is_device(e)]
    kernels: dict = {}
    launches = 0
    for e in dev:
        k = kernels.setdefault(e.name(), [0, 0.0])
        k[0] += 1
        k[1] += e.duration_ns() * 1e-9
        if not e.name().startswith(NOT_KERNELS):
            launches += 1
    merged = _union([(e.start_ns(), e.start_ns() + e.duration_ns()) for e in dev])
    busy = sum(e - s for s, e in merged) * 1e-9
    # The traced stretch on the profiler's clock: from the first step's range
    # to the last event.
    steps = [e.start_ns() for e in host if e.name() == "bench.step"]
    t0_ns = min(steps) if steps else min(e.start_ns() for e in raw)
    t1_ns = max(e.start_ns() + e.duration_ns() for e in raw)
    gaps = []
    edges = [t0_ns] + [x for m in merged for x in m] + [t1_ns]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e > s:
            gaps.append((e - s, s + (e - s) // 2))
    gaps.sort(reverse=True)
    idle = [[_gap_name(mid, host), d * 1e-9] for d, mid in gaps[:TOP]]
    return Reading(steps=n, window_s=wall, busy_s=busy, launches=launches, kernels=kernels,
                   ranges=ranges, idle_gaps=idle)
