"""fit(devices=2) under torchrun: `python -m torch.distributed.run
--standalone --nproc_per_node 2 -m sps_torch.scripts.train ... --devices 2
--device cpu` on tests/test_torch_dp.py's world. torchrun sets RANK and
WORLD_SIZE, so each of its processes is one rank of fit's data-parallel loop
(gloo); the run writes what the spawned one writes: both epochs trained and
validated, logged once (the log appends, so two processes that each ran
the whole fit would log every epoch twice), best.pt and last.pt."""

import os
import subprocess
import sys

from test_torch_dp import _ROOT, _check_fit_outputs, _fit_args


def test_fit_devices_2_under_torchrun(tmp_path):
    ckpt_dir, log_dir, args = _fit_args(tmp_path)
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE")}
    env["PYTHONPATH"] = os.pathsep.join([_ROOT, *filter(None, [env.get("PYTHONPATH")])])
    # torchrun starts each rank in a session of its own and, on SIGTERM,
    # kills those sessions; a hung run is ended that way at the timeout.
    log = tmp_path / "torchrun.log"
    with open(log, "w") as out:
        proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                                 "--nproc_per_node", "2", "-m", "sps_torch.scripts.train", *args],
                                cwd=tmp_path, env=env, stdout=out, stderr=subprocess.STDOUT)
        try:
            proc.wait(timeout=180)
        finally:
            if proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
    assert proc.returncode == 0, log.read_text()[-8000:]
    _check_fit_outputs(ckpt_dir, log_dir)
