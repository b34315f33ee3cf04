"""The control and the faults: a run comes out not correct when the timed
path computes one precision lower (the reference in fp8 put in the
program's place), when it returns a stale state, leaves half of its batch
out, alters its scores where it produces them, or thresholds its keep mask
anywhere but at the configuration's threshold. Each drives the rest of a
tiny CPU run with the real limits of the cell."""

import numpy as np
import pytest
import torch

from benchmark import common, run
from benchmark import calibrate
from benchmark.kinds import stream


def _limits_hold(checks):
    return all(c["ok"] for c in checks)


def test_stream_control_is_not_correct(tiny):
    bench, root = tiny
    ctx = common.context(bench, "blt.stream", 21, 0.5, False, "cpu", 0.0, root)
    st = stream.Stream(ctx)
    win = st.window(0.5)
    st.free()
    assert _limits_hold(st.ref.compare(win["samples"]))
    assert not _limits_hold(st.ref.compare(calibrate.control_samples(st, win["samples"])))


def _stale(real):
    """Each call returns the previous call's outputs."""
    prev = []

    def call(self, *a):
        prev.append(real(self, *a))
        return prev[-2] if len(prev) > 1 else prev[-1]
    return call


def _half(real):
    def call(self, scan, valid, labels, pose):
        s, k, stats = real(self, scan, valid, labels, pose)
        s = s.clone()
        s[len(s) // 2:] = 0.0
        return s, (s <= self.eps) & torch.as_tensor(valid), stats
    return call


def _altered(real):
    def call(self, scan, valid, labels, pose):
        s, k, stats = real(self, scan, valid, labels, pose)
        s = torch.clamp(s + 0.1, 0.0, 1.0) * torch.as_tensor(valid)
        return s, k, stats
    return call


def _threshold(real):
    """Scores as computed; keep at another threshold than the config's."""
    def call(self, scan, valid, labels, pose):
        s, k, stats = real(self, scan, valid, labels, pose)
        return s, (s <= 0.5) & torch.as_tensor(valid), stats
    return call


@pytest.mark.parametrize("fault", [_stale, _half, _altered, _threshold])
def test_stream_fault_is_not_correct(tiny, monkeypatch, fault):
    from sps_torch.stream.engine import StreamingFilter

    monkeypatch.setattr(StreamingFilter, "__call__", fault(StreamingFilter.__call__))
    bench, root = tiny
    r = run.run_cell(bench, "blt.stream", 22, 2.0, False, "cpu", 0.0, root)
    assert r["correct"] is False


def test_every_cell_has_its_limits():
    """Each cell of BENCHMARK.json has a limits file holding exactly the
    numbers its kind compares, each a finite positive limit."""
    import json
    import os

    from conftest import BENCH, ROOT

    compared = {"stream": {"score_gap_mean"}}
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for cell in bench["workloads"]:
        with open(os.path.join(BENCH, "traffic", cell["traffic"] + ".json")) as f:
            kind = json.load(f)["kind"]
        with open(os.path.join(BENCH, "limits", cell["name"] + ".json")) as f:
            lim = json.load(f)
        assert set(lim) == compared[kind]
        assert all(np.isfinite(v) and v > 0 for v in lim.values())
