"""Profiling helpers (counterpart of sps_tpu/utils/profiling.py): a
torch.profiler trace and wall-clock timing per named stage.

sps_tpu's latch_sync_mode has no counterpart: it forced the TPU runtime out
of its lazy dispatch, and CUDA has no such latch. Kernels run asynchronously
to the host, so StageTimer synchronizes the device of the tensors it is
given before it reads the clock."""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils import _pytree


def synchronize(tree) -> None:
    """Wait for every CUDA device that holds a tensor of `tree` (a tensor or
    a nest of tuples, lists, dicts and named tuples), jax.block_until_ready's
    counterpart; CPU tensors need no wait."""
    devices = {x.device for x in _pytree.tree_leaves(tree)
               if isinstance(x, torch.Tensor) and x.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def device_trace(log_dir: str | None):
    """torch.profiler over the block, host and (where present) CUDA
    activities; yields the profiler and writes log_dir/trace.json
    (chrome://tracing, Perfetto) unless log_dir is None."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StageTimer:
    """Accumulates wall time per named stage (the reference's T/P/I log);
    `samples` keeps each stage's times in seconds."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.samples: dict[str, list[float]] = {}

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        """Time the block. block_on: the stage's output (or a callable
        returning it), synchronized before the clock is read. The clock
        starts at entry: work queued before it counts unless the caller
        synchronized first."""
        t0 = time.perf_counter()
        yield
        if block_on is not None:
            synchronize(block_on() if callable(block_on) else block_on)
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1
        self.samples.setdefault(name, []).append(dt)

    def summary(self) -> dict[str, float]:
        return {
            k: self.totals[k] / max(self.counts[k], 1) for k in sorted(self.totals)
        }
