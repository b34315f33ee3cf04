"""What sp moves per scan (CPU, two gloo ranks spawned by
parallel/launch.py):

  * sps_torch/scripts/measure_sp_scaling.py's analytic_nclt rows equal
    sps_tpu's (scripts/measure_sp_scaling.py runs in a subprocess: it sets
    XLA_FLAGS when imported);
  * parallel/comm.py's COLLECTIVES: the output bytes of every all-gather,
    all-to-all and all-reduce, (a) of gather_source on every sliced level
    of a scan's pyramid, all-gather and ghost exchange (ghost_frac 0.5),
    against the sums the sliced levels' shapes give, and (b) of a whole sp
    StreamingFilter scan, against each collective's input as the comm API
    was called with it (tests/test_torch_spatial.py's streaming
    configuration, narrowed, and its world);
  * measured_rows at two ranks: both modes, no overflow, equal scores on
    the ranks, the ghost exchange moving fewer bytes, and the JAX script's
    tables with sps_tpu's HLO counts beside the port's.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sps_torch.models import spsnet as tsps
from sps_torch.parallel import launch
from sps_torch.scripts import measure_sp_scaling

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_analytic_nclt_equals_sps_tpu():
    code = ("import json, sys; sys.path.insert(0, 'scripts'); import measure_sp_scaling as m; "
            "print(json.dumps(m.analytic_nclt('config/config_nclt.yaml')))")
    r = subprocess.run([sys.executable, "-c", code], cwd=_ROOT, capture_output=True, text=True,
                       timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr
    want = json.loads(r.stdout.strip().splitlines()[-1])
    got = measure_sp_scaling.analytic_nclt(os.path.join(_ROOT, "config", "config_nclt.yaml"))
    assert got == want and len(got) == 15


def _sp_config():
    """tests/test_torch_spatial.py's streaming configuration (narrowed)."""
    from test_torch_spatial import filter_config

    return filter_config()


def _sp_world(cfg):
    rng = np.random.default_rng(3)
    n = 700
    scan = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    mp = np.concatenate([scan[: n // 2] + rng.normal(0, 0.02, (n // 2, 3)).astype(np.float32),
                         rng.uniform(5, 9, (2000, 3)).astype(np.float32)])
    ns = cfg.tpu.scan_points
    sx = np.zeros((ns, 3), np.float32)
    sx[:n] = scan
    return mp, sx, np.arange(ns) < n


def _out_bytes(kind, x, n):
    """A collective's output bytes from its input: the all-gather's n blocks."""
    return x.numel() * x.element_size() * (n if kind == "all-gather" else 1)


def collectives_rank(rank, world):
    """Rank `rank`: COLLECTIVES against the bytes the call sites' inputs give,
    (a) gather_source on every sliced level of a scan's pyramid, all-gather
    and ghost exchange; (b) a whole sp StreamingFilter scan, each collective
    entered through the comm API recorded by its input."""
    from sps_torch.parallel import comm
    from sps_torch.parallel import mesh as pm
    from sps_torch.parallel import spatial as sp
    from sps_torch.stream.engine import StreamingFilter

    cfg = _sp_config()
    sd = tsps.init_state_dict(cfg.sps_config(1), seed=0)
    mp, sx, sv = _sp_world(cfg)
    mesh = pm.make_mesh(world, "sp")
    out = {}
    one = StreamingFilter(cfg, sd, mp, device="cpu")
    with torch.inference_mode():
        vx = one.stage_vox(torch.from_numpy(sx)[None], torch.from_numpy(sv)[None],
                           torch.eye(4)[None])
        levels, _ = one.stage_topo(vx.grid)
    for frac in (0.0, 0.5):
        sliced = sp.slice_levels(levels, "sp", frac)
        comm.reset_counts()
        want = {"all-gather": [0, 0], "all-to-all": [0, 0]}
        for lv in sliced:
            occ = lv.grid.occ
            feats = torch.ones(occ.shape[:-1] + (2 * occ.shape[-1],), dtype=torch.bfloat16)
            got = sp.gather_source(feats, lv, "self", "sp")
            row = feats[0].numel() * feats.element_size()
            ids = getattr(lv, "ghost_self", None)
            if ids is None:
                assert got.shape[0] == world * feats.shape[0]
                want["all-gather"][0] += 1
                want["all-gather"][1] += world * feats.shape[0] * row
            else:
                want["all-gather"][0] += 1
                want["all-gather"][1] += world * ids.numel() * ids.element_size()
                want["all-to-all"][0] += 1
                want["all-to-all"][1] += world * ids.numel() * row
        out[f"levels/{frac}"] = (want, {k: [v["count"], v["bytes"]]
                                        for k, v in comm.COLLECTIVES.items()})
    seen = {"all-gather": [0, 0], "all-to-all": [0, 0], "all-reduce": [0, 0]}
    api = {"all_gather": "all-gather", "all_to_all": "all-to-all", "psum": "all-reduce",
           "pmax": "all-reduce"}
    originals = {name: getattr(comm, name) for name in api}

    def recorder(name):
        def call(x, axis):
            kind = api[name]
            seen[kind][0] += 1
            seen[kind][1] += _out_bytes(kind, x, comm.size(axis))
            return originals[name](x, axis)
        return call

    for frac in (0.0, 0.5):
        filt = StreamingFilter(cfg, sd, mp, device="cpu", mesh=mesh, sp_ghost_frac=frac)
        for name in api:
            setattr(comm, name, recorder(name))
        try:
            for rec in seen.values():
                rec[0] = rec[1] = 0
            comm.reset_counts()
            scores, _, stats = filt(sx, sv, np.zeros(len(sv), np.float32),
                                    np.eye(4, dtype=np.float32))
        finally:
            for name, fn in originals.items():
                setattr(comm, name, fn)
        out[f"filter/{frac}"] = ({k: list(v) for k, v in seen.items()},
                                 {k: [v["count"], v["bytes"]]
                                  for k, v in comm.COLLECTIVES.items()},
                                 bool(stats["overflow"]), scores.numpy())
    return out


@pytest.fixture(scope="module")
def collectives():
    return launch.spawn(collectives_rank, 2, timeout=300.0)


@pytest.mark.parametrize("frac", [0.0, 0.5], ids=["all-gather", "ghost"])
def test_collectives_count_the_sliced_levels_bytes(collectives, frac):
    for res in collectives:
        want, got = res[f"levels/{frac}"]
        assert got["all-reduce"] == [0, 0]
        for kind in ("all-gather", "all-to-all"):
            assert got[kind] == want[kind], (kind, got, want)
        assert got["all-gather"][0] == 5
        assert (got["all-to-all"][0] > 0) == (frac > 0)


@pytest.mark.parametrize("frac", [0.0, 0.5], ids=["all-gather", "ghost"])
def test_collectives_count_an_sp_filter_scan(collectives, frac):
    for res in collectives:
        want, got, overflow, _ = res[f"filter/{frac}"]
        assert not overflow
        assert got == want, (got, want)
        assert got["all-reduce"][0] == 1  # the overflow flags' pmax (eval: no BN psum)
        assert (got["all-to-all"][0] > 0) == (frac > 0)
    a, b = (res[f"filter/{frac}"][3] for res in collectives)
    np.testing.assert_array_equal(a, b)


def test_measured_rows_on_two_ranks():
    cfg = _sp_config()
    sd = tsps.init_state_dict(cfg.sps_config(1), seed=0)
    mp, sx, sv = _sp_world(cfg)
    rows = measure_sp_scaling.measured_rows(cfg, sd, mp, sx, sv, widths=(2,), device="cpu",
                                            timeout=300.0, log=lambda m: None)
    assert [(r["n_sp"], r["mode"], r["ghost_frac"]) for r in rows] == [
        (2, "all-gather", 0.0), (2, "ghost", 0.5)]
    for r in rows:
        assert not r["overflow"] and r["scores_equal"] and r["host_staged"] == 0
        assert r["total_count"] == sum(r[k]["count"] for k in ("all-gather", "all-to-all",
                                                                 "all-reduce"))
        assert r["all-reduce"]["count"] == 1
    gather, ghost = rows
    assert gather["all-to-all"]["count"] == 0 < ghost["all-to-all"]["count"]
    assert ghost["total_bytes"] < gather["total_bytes"]
    lines = measure_sp_scaling.tables(rows, measure_sp_scaling.analytic_nclt(
        os.path.join(_ROOT, "config", "config_nclt.yaml")), measure_sp_scaling.reference_rows())
    assert lines[2].startswith("| 2 | all-gather |") and "| 26 | 3244.16 |" in lines[2]
    assert lines[-1].startswith("| L4 | row |")
