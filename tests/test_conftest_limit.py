"""The root conftest.py's time limit and CPU share, run in a pytest of their own."""

import os
import pathlib

CONFTEST = pathlib.Path(__file__).resolve().parents[1] / "conftest.py"

INNER = '''
import os
import signal
import time

import pytest
import torch


@pytest.mark.limit(1)
def test_sleeps_past_its_limit():
    time.sleep(5)


@pytest.mark.limit(1)
def test_hangs_where_the_alarm_cannot_reach():
    signal.pthread_sigmask(signal.SIG_BLOCK, [signal.SIGALRM])
    try:
        time.sleep(3)
    finally:
        signal.pthread_sigmask(signal.SIG_UNBLOCK, [signal.SIGALRM])


@pytest.mark.limit(2)
def test_under_its_limit():
    time.sleep(0.2)


def test_after_a_short_limit():
    time.sleep(2.5)
    assert signal.getitimer(signal.ITIMER_REAL)[0] > 250


def test_share():
    share = int(os.environ["EXPECT_SHARE"])
    assert torch.get_num_threads() == share
    assert [os.environ[v] for v in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "NPROC")] == [str(share)] * 3
'''

# Outside every test phase (after teardown and its report) no alarm is left.
PROBE = '''
import signal

def pytest_runtest_logfinish(nodeid):
    print("\\nITIMER", nodeid.split("::")[-1], signal.getitimer(signal.ITIMER_REAL)[0])
'''


def _run(pytester, *args):
    pytester.makeconftest(CONFTEST.read_text())
    pytester.makepyfile(test_inner=INNER, probe=PROBE)
    return pytester.runpytest_subprocess("-p", "probe", "-s", "-p", "no:cacheprovider",
                                         *args, timeout=240)


def test_limit_fails_a_test_past_it_and_passes_one_under_it(pytester):
    r = _run(pytester, "-k", "sleeps_past or hangs or under")
    r.assert_outcomes(failed=2, passed=1)
    r.stdout.re_match_lines([r".*test_inner.py::test_sleeps_past_its_limit exceeded its 1 s "
                             r"limit \(1\.\d s\)"])
    # A hang the alarm cannot interrupt (here: the signal blocked, as in a
    # native call) prints every stack at the deadline, and fails once the
    # alarm gets through.
    r.stderr.fnmatch_lines(["Timeout (0:00:0*)!",
                            "*test_inner.py*in test_hangs_where_the_alarm_cannot_reach"])
    r.stdout.re_match_lines([r".*test_inner.py::test_hangs_where_the_alarm_cannot_reach "
                             r"exceeded its 1 s limit \(3\.\d s\)"])


def test_timer_is_disarmed_after_teardown(pytester):
    r = _run(pytester, "-k", "under or after")
    r.assert_outcomes(passed=2)
    assert r.stdout.lines.count("ITIMER test_under_its_limit 0.0") == 1
    assert r.stdout.lines.count("ITIMER test_after_a_short_limit 0.0") == 1


def test_worker_takes_its_cpu_share(pytester, monkeypatch):
    """A faked two-worker xdist environment: torch, OpenMP, MKL and XLA
    (NPROC) all get half the CPUs, whatever OMP_NUM_THREADS said before."""
    share = max(1, len(os.sched_getaffinity(0)) // 2)
    for k, v in {"PYTEST_XDIST_WORKER": "gw1", "PYTEST_XDIST_WORKER_COUNT": "2",
                 "EXPECT_SHARE": str(share), "OMP_NUM_THREADS": "99"}.items():
        monkeypatch.setenv(k, v)
    _run(pytester, "-k", "share").assert_outcomes(passed=1)


def test_cpu_share(pytestconfig):
    cpu_share = _root(pytestconfig).cpu_share
    cpus = len(os.sched_getaffinity(0))
    assert cpu_share({}) == cpus
    worker = {"PYTEST_XDIST_WORKER": "gw0"}
    assert cpu_share({**worker, "PYTEST_XDIST_WORKER_COUNT": "2"}) == max(1, cpus // 2)
    assert cpu_share({**worker, "PYTEST_XDIST_WORKER_COUNT": str(cpus + 1)}) == 1


def _root(pytestconfig):
    """The root conftest module, as pytest loaded it."""
    return next(p for p in pytestconfig.pluginmanager.get_plugins()
                if getattr(p, "__file__", None) and pathlib.Path(p.__file__).resolve() == CONFTEST)


def test_named_tests_exist(pytestconfig):
    """Every test the root conftest marks or groups by nodeid is still a
    test of its file, so a rename cannot drop a mark unseen."""
    root = _root(pytestconfig)
    for nodeid in {*root.SLOW, *root.LIMITS, *root.GROUPS}:
        path, name = nodeid.split("::")
        assert f"\ndef {name}(" in (CONFTEST.parent / path).read_text(), nodeid


def test_scope_groups_a_file_only_where_named(pytestconfig):
    scope = _root(pytestconfig).scope
    assert scope("tests/test_minkunet.py::test_atlas_engine_matches_gather_engine") == (
        "tests/test_minkunet.py@atlas")
    assert scope("tests/test_minkunet.py::test_stem_zband_matches_halo_stem") == (
        "tests/test_minkunet.py")
    assert scope("tests/test_torch_loop.py::test_loop_matches_sps_tpu[refine]") == (
        "tests/test_torch_loop.py")
