"""A streaming cell: the program's StreamingFilter over a replayed trajectory.

Set-up makes the world and the distinct scans from the seed (benchmark/
world.py), the weights on the device (benchmark/weights.py), hands them to
the program through its MinkowskiEngine loader, builds the filter on the
map and warms it up over a full topology-reuse cycle and one more
rebuild. The window then replays the scans in the traffic's order, one in
flight: each call from the host arrays to scores and keep mask complete
on the device is timed on the host clock with a synchronize() on either
side, as long as `--seconds` lasts. A seeded reservoir keeps the outputs
of a few rebuild and reuse calls, which the plain reference
(benchmark/reference/filter.py) recomputes once the window has closed and
the program's state is freed. With --trace the profiler covers whole reuse
cycles after the window.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import common, trace, weights, world
from benchmark.reference import filter as rf
from benchmark.reference import minkunet as mk
from benchmark.work import brick_int8
from benchmark.work import minkunet as mk_work


def replay_order(n: int, order: str) -> list:
    if order == "pingpong":  # consecutive scans one step apart, both ways
        return list(range(n)) + list(range(n - 2, 0, -1))
    raise ValueError(f"unknown order {order!r}")


class Reservoir:
    """A uniform seeded sample of k items from a stream of unknown length."""

    def __init__(self, k: int, rng):
        self.k, self.rng, self.items, self.seen = k, rng, [], 0

    def offer(self, item):
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(self.seen))
            if j < self.k:
                self.items[j] = item


# A keep bit may differ from the reference's only where the reference's
# score lies within this of the threshold: above the widest gap of any
# sound run (0.56 over 36 seeds a cell, PERF.md), so that no rounding can
# flip a bit this far out.
KEEP_FAR = 0.7


class Stream:
    """The cell's inputs and the program's filter, set up and warmed."""

    def __init__(self, ctx: common.Context):
        from sps_torch import config as pconfig
        from sps_torch.convert import state_dict_from_me
        from sps_torch.stream.engine import StreamingFilter

        self.ctx = ctx
        dev, tr, wd = ctx.device, ctx.traffic, ctx.config["world"]
        marks = [("start", time.perf_counter())]
        self.cfg = cfg = pconfig.load(ctx.config_path)
        self.arch = mk.Arch.of(ctx.config["model"])
        self.stable, self.scans, self.labels, self.valids = world.make_data(
            ctx.seed, cfg.tpu.scan_points, tr["distinct_scans"], wd["extent_m"], tr["step_m"],
            wd["n_rays"], wd["max_range_m"])
        self.order = replay_order(tr["distinct_scans"], tr["order"])
        marks.append(("world", time.perf_counter()))
        self.ref = Reference(self)
        self.w = weights.calibrated(self.arch, ctx.seed, dev,
                                    mk.Pyramid(self.ref.scan(0, every=1).sites, self.arch))
        marks.append(("weights", time.perf_counter()))
        if dev.startswith("cuda"):  # the peak is the program's, not the calibration's
            torch.cuda.reset_peak_memory_stats()
        self.filt = StreamingFilter(cfg, state_dict_from_me(self.w), self.stable, device=dev)
        self.every = max(self.filt.topo_every, 1)
        self.pose = np.eye(4, dtype=np.float32)  # the scans are made in the map frame
        marks.append(("filter", time.perf_counter()))
        for k in range(tr["warmup_scans"]):
            self.call(k)
        self.filt.invalidate()
        common.sync(dev)
        marks.append(("warm-up", time.perf_counter()))
        common.log_marks(ctx.t0, marks)

    def call(self, k):
        i = self.order[k % len(self.order)]
        return self.filt(self.scans[i], self.valids[i], self.labels[i], self.pose)

    def window(self, seconds: float) -> dict:
        """Replay from a fresh rebuild for `seconds`; a seeded sample of the
        rebuild and reuse calls' outputs is kept for the reference."""
        ctx, tr, dev = self.ctx, self.ctx.traffic, self.ctx.device
        rng = np.random.default_rng(ctx.seed)
        rebuilds = Reservoir(tr["sample_rebuilds"], rng)
        reuses = Reservoir(tr["sample_reuses"], rng)
        lat, overflow = [], []
        common.sync(dev)
        start = time.perf_counter()
        k = 0
        while True:
            common.sync(dev)
            t = time.perf_counter()
            scores, keep, stats = self.call(k)
            common.sync(dev)
            now = time.perf_counter()
            lat.append(now - t)
            overflow.append(stats["overflow"])
            (rebuilds if k % self.every == 0 else reuses).offer((k, scores, keep))
            k += 1
            if now - start >= seconds:
                break
        return {"start": start, "seconds": time.perf_counter() - start, "calls": k, "lat": lat,
                "failed": int(torch.stack(overflow).sum()),
                "samples": rebuilds.items + reuses.items}

    def free(self) -> int:
        """The peak device memory so far; then the program's state is freed."""
        dev = self.ctx.device
        peak = torch.cuda.max_memory_allocated() if dev.startswith("cuda") else 0
        del self.filt
        gc.collect()
        if dev.startswith("cuda"):
            torch.cuda.empty_cache()
        return peak


def run(ctx: common.Context) -> dict:
    st = Stream(ctx)
    win = st.window(ctx.seconds)
    reading = None
    if ctx.trace:
        st.filt.invalidate()
        reading = trace.traced(st.call, ctx.traffic["trace_scans"],
                               lambda: common.sync(ctx.device))
    peak = st.free()
    checks = st.ref.compare(win["samples"])
    if reading is not None:
        reading.work.update(st.ref.work(ctx.traffic["trace_scans"]))
    return {
        "metrics": {"filter_scans_per_s": win["calls"] / win["seconds"],
                    "filter_ms.p95": 1e3 * float(np.percentile(win["lat"], 95)),
                    "setup_s": win["start"] - ctx.t0},
        "attempted": win["calls"], "failed": win["failed"], "checks": checks,
        "reading": reading, "memory_peak_bytes": peak,
    }


class Reference:
    """The plain reference on the cell's own inputs."""

    def __init__(self, st: "Stream"):
        self.st, self.dev = st, st.ctx.device
        self.mapv = rf.map_sites(torch.from_numpy(st.stable).to(self.dev), st.cfg.voxel_size)
        self.pose = torch.eye(4, device=self.dev)

    def _points(self, i):
        st = self.st
        x = rf.posed(torch.from_numpy(st.scans[i]).to(self.dev), self.pose)
        return x, torch.from_numpy(st.valids[i]).to(self.dev)

    def scan(self, k, every=None) -> rf.Scan:
        """Call k's sites: a rebuild's own, or clipped to the brick set of
        its cycle's rebuild."""
        st = self.st
        cfg, bs, every = st.cfg, st.cfg.tpu.brick_side, every or st.every
        x, v = self._points(st.order[k % len(st.order)])
        kr = k - k % every
        cached = None
        if kr != k:
            cached = rf.bricks_of(*self._points(st.order[kr % len(st.order)]),
                                  cfg.voxel_size, bs)
        return rf.Scan(x, v, cfg.voxel_size, self.mapv, cached=cached, brick_side=bs)

    def scores(self, k, **precision) -> tuple:
        """(scan, reference scores) of call k."""
        sc = self.scan(k)
        with common.F32():
            return sc, rf.scores(self.st.w, self.st.arch, sc, **precision)

    def compare(self, samples, limits=None, extra=None) -> list:
        """The compared numbers over the sampled calls (k, scores, keep):
        the mean score gap to the reference over their valid points; the
        points whose keep bit is not (the call's own score <= threshold)
        and valid, which with the gap ties the mask to the reference; the
        valid points whose keep bit differs from the reference's (score <=
        threshold) although the reference's score lies more than KEEP_FAR
        from the threshold; and the points outside the cached topology that
        do not score exactly 0.5. `extra` receives the widest gap, its 99th
        percentile and the share of all keep bits that differ, which are
        reported but not compared (PERF.md, section 2)."""
        lim = limits or self.st.ctx.limits
        eps = self.st.cfg.threshold
        gaps, flips, far, miss_off, off_own = [], 0, 0, 0, 0
        for k, scores, keep in sorted(samples, key=lambda s: s[0]):
            sc, r = self.scores(k)
            v, keep = sc.valid, keep.to(self.dev)
            off_own += int((keep != ((scores.to(self.dev) <= eps) & v)).sum())
            s = scores.float().to(self.dev)
            gaps.append((s - r).abs()[v])
            flip = (keep != (r <= eps)) & v
            flips += int(flip.sum())
            far += int((flip & ((r - eps).abs() > KEEP_FAR)).sum())
            miss_off += int((sc.miss & (s != 0.5)).sum())
        d = torch.cat(gaps)
        if extra is not None:
            extra["score_gap_max"] = float(d.max())
            extra["score_gap_p99"] = float(torch.quantile(d, 0.99))
            extra["keep_flip_share"] = flips / max(len(d), 1)
        return [common.check("score_gap_mean", float(d.mean()), lim["score_gap_mean"]),
                common.check("keep_not_score", off_own, 0),
                common.check("keep_off_far", far, 0),
                common.check("miss_not_half", miss_off, 0)]

    def work(self, n: int) -> dict:
        """Operations and the int8 conv's bound of the traced calls 0..n-1."""
        cfg, arch = self.st.cfg, self.st.arch
        levels = tuple(range(cfg.tpu.row_from)) if cfg.tpu.int8 else ()
        ops, bound = 0, 0.0
        for k in range(n):
            pyr = mk.Pyramid(self.scan(k).sites, arch)
            ops += mk_work.operations(pyr, arch)
            bound += brick_int8.bound_s(pyr, arch, levels, cfg.tpu.brick_side, 2,
                                        2 if cfg.tpu.bf16 else 4)
        return {"model_ops": ops, "int8_bound_s": bound}
