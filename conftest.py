"""Tier-1's run-time rules: one CPU share per xdist worker, a time limit on
every test, the marks of sps_tpu's own slow tests, and how files go to
workers. Loaded before tests/conftest.py, so the caps below are in place
before torch or XLA start.

CPU share: under `-n N` every worker gets len(sched_getaffinity) // N CPUs
(at least 1). Torch's intra- and inter-op threads, OpenMP and MKL take that
many threads, and so do XLA:CPU's pools (XLA sizes them from NPROC). Left
to themselves, each of six workers sized its pools to the whole machine and
the run spent its time switching threads. The caps are set in the
environment, so the ranks and CLI subprocesses a test spawns inherit them.
A run without xdist keeps the whole machine.

Time limit: each test's setup, call and teardown together get LIMIT_S
seconds, or `@pytest.mark.limit(seconds)` with its reason beside it. At the
deadline a SIGALRM fails the test with its nodeid and elapsed time, and
faulthandler prints every thread's stack, which names a hang in native code
(an XLA compile, a gloo or XLA collective) that the alarm cannot interrupt.
xdist runs tests on each worker's main thread, so the alarm reaches them.

XLA's collective timeouts are set here below LIMIT_S (tests/conftest.py
adds its own only where none is set). A rendezvous still waiting after
COLLECTIVE_S, even one that is merely slow, makes XLA abort the whole
worker process, below the test's own limit: its log goes to stderr, xdist
reports the running test as crashed, starts a new worker and hands it the
old one's unfinished tests.
"""

import collections
import faulthandler
import os
import signal
import sys
import time

import pytest

pytest_plugins = ["pytester"]
LIMIT_S = 300.0
COLLECTIVE_S = 240
_START = pytest.StashKey[float]()
_STDERR = pytest.StashKey[int]()

# sps_tpu's own tests that need over 150 s alone (pytest <nodeid>, 8 CPUs),
# most of it XLA compiles. Tier-1 deselects them (`-m 'not slow'`), `-m slow`
# runs them. sps_tpu is frozen, so no change to the repo can change what they
# check.
SLOW = {
    "tests/test_baseline_filters.py::test_mos4d_filter_buffer",
    "tests/test_baselines.py::test_mos4d_forward",
    "tests/test_int8_parity.py::test_int8_uiou_within_half_point",
    "tests/test_minkunet.py::test_stem_zband_matches_halo_stem",
    "tests/test_parallel.py::test_dp_grad_matches_single_device",
    "tests/test_spatial.py::test_sp_forward_matches_single_device",
    "tests/test_spatial.py::test_sp_ghost_exchange_matches_single_device",
    "tests/test_stream.py::test_streaming_matches_materialized_submap",
}
# Limits of sps_tpu's own tests above LIMIT_S, with their seconds on a
# worker of `-n 6` on 8 CPUs. (The port's tests carry theirs as marks.)
LIMITS = {
    **{nodeid: 1200 for nodeid in SLOW},
    "tests/test_baseline_filters.py::test_mapmos_filter": 600,  # 241 s
    "tests/test_baselines.py::test_mapmos_forward_and_features": 600,  # 215 s
    "tests/test_dist_feature.py::test_stable_weight_loss_changes_gradient": 600,  # 175 s
    "tests/test_e2e.py::test_remat_grads_match": 600,  # 231 s
    "tests/test_e2e.py::test_train_resume": 600,  # 331 s
    "tests/test_loop.py::test_loop_tracks_sequence": 600,  # 279 s
    "tests/test_minkunet.py::test_aliased_row_levels_match_gather_engine": 600,  # 234 s
    "tests/test_minkunet.py::test_atlas_engine_matches_gather_engine": 600,  # 336 s
    "tests/test_minkunet.py::test_hybrid_row_levels_match_gather_engine": 600,  # 284 s
    "tests/test_minkunet.py::test_zband_conv_mode_matches_gather_engine": 600,  # 165 s
    "tests/test_parallel.py::test_dp_step_runs_on_8_device_mesh": 600,  # 206 s
    "tests/test_spatial.py::test_sp_ghost_overflow_is_reported": 600,  # 254 s
    "tests/test_spatial.py::test_sp_streaming_filter_matches_single_device": 600,  # 149 s
    "tests/test_spatial.py::test_sp_train_stats_match_single_device": 600,  # 165 s
    "tests/test_stream.py::test_replay_sequence_streams_via_native_replayer": 600,  # 154 s
    "tests/test_topo_reuse.py::test_reuse_matches_full_rebuild_bitwise": 600,  # 160 s
}
# A file's tests go to one worker, except groups named here, which go as a
# unit of their own: test_minkunet.py alone set a path of ~1,100 s.
GROUPS = {
    "tests/test_minkunet.py::test_aliased_row_levels_match_gather_engine": "atlas",
    "tests/test_minkunet.py::test_atlas_engine_matches_gather_engine": "atlas",
    "tests/test_minkunet.py::test_hybrid_row_levels_match_gather_engine": "atlas",
    "tests/test_minkunet.py::test_zband_conv_mode_matches_gather_engine": "atlas",
}


def cpu_share(environ=os.environ):
    """This process's CPUs: a worker's share under xdist, else all of them."""
    cpus = len(os.sched_getaffinity(0))
    if "PYTEST_XDIST_WORKER" not in environ:
        return cpus
    return max(1, cpus // int(environ["PYTEST_XDIST_WORKER_COUNT"]))


def scope(nodeid):
    """The unit of work a test goes to a worker in: its file, or its group."""
    path = nodeid.split("::", 1)[0]
    group = GROUPS.get(nodeid.split("[", 1)[0])
    return f"{path}@{group}" if group else path


if "PYTEST_XDIST_WORKER" in os.environ:
    SHARE = cpu_share()
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "NPROC"):
        os.environ[var] = str(SHARE)
    import torch

    torch.set_num_threads(SHARE)
    torch.set_num_interop_threads(SHARE)

if "collective_call_terminate_timeout" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_cpu_collective_call_terminate_timeout_seconds={COLLECTIVE_S}"
        f" --xla_cpu_collective_timeout_seconds={COLLECTIVE_S}"
        " --xla_cpu_collective_call_warn_stuck_timeout_seconds=60"
    ).strip()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: needs minutes alone; tier-1 deselects it (run with -m slow)")
    config.addinivalue_line(
        "markers", f"limit(seconds): this test's time limit (default {LIMIT_S:g} s)")
    config.option.loadscopereorder = False  # pytest_collection_modifyitems orders
    # Global capture is suspended here, so this is the terminal's stderr.
    config.stash[_STDERR] = os.dup(sys.stderr.fileno())


def pytest_collection_modifyitems(config, items):
    """Mark SLOW and LIMITS, then order the units of work (scope()) in turns,
    one of sps_tpu's own, one of the port's (test_torch_*), each side by its
    units' number of tests, most first. sps_tpu's units compile XLA programs
    for minutes; in turns with the port's they keep the CPUs busy without
    crowding them. (By xdist's `--dist loadfile` alone, every file ordered by
    its number of tests, sps_tpu's few-test files came last and set the
    run's end.) Deselection by `-m` comes after this hook."""
    for item in items:
        nodeid = item.nodeid.split("[", 1)[0]
        if nodeid in SLOW:
            item.add_marker(pytest.mark.slow)
        if nodeid in LIMITS:
            item.add_marker(pytest.mark.limit(LIMITS[nodeid]))
    count = collections.Counter(scope(item.nodeid) for item in items)
    sides = ([], [])
    for unit in sorted(count, key=lambda u: -count[u]):
        sides[unit.rsplit("/", 1)[-1].startswith("test_torch_")].append(unit)
    turn = {unit: (i, side) for side, units in enumerate(sides) for i, unit in enumerate(units)}
    items.sort(key=lambda item: turn[scope(item.nodeid)])


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    """`--dist loadfile`, with the units of scope()."""
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    class Scheduler(LoadFileScheduling):
        def _split_scope(self, nodeid):
            return scope(nodeid)

    return Scheduler(config, log)


def _arm(item):
    """Arm the alarm (and the stack dump) for the rest of the test's limit."""
    marker = item.get_closest_marker("limit")
    limit = float(marker.args[0]) if marker else LIMIT_S
    start = item.stash.setdefault(_START, time.monotonic())
    left = max(start + limit - time.monotonic(), 1e-3)

    def expire(signum, frame):
        pytest.fail(f"{item.nodeid} exceeded its {limit:g} s limit "
                    f"({time.monotonic() - start:.1f} s)", pytrace=True)

    signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, left)
    faulthandler.dump_traceback_later(left, file=item.config.stash[_STDERR])


@pytest.hookimpl(hookwrapper=True)
def _limited(item):
    _arm(item)
    yield
    signal.setitimer(signal.ITIMER_REAL, 0)
    faulthandler.cancel_dump_traceback_later()


pytest_runtest_setup = pytest_runtest_call = pytest_runtest_teardown = _limited
