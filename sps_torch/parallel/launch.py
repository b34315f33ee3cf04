"""One process per rank: `spawn(fn, world, *args)` starts `world` processes
(multiprocessing's spawn method), each of which joins a process group over
tcp://127.0.0.1 on a free port, runs fn(rank, world, *args) and hands its
return value back through a file. A rank that fails raises in the caller
with its traceback; ranks still running at `timeout` seconds are killed and
the call raises, so a hung collective cannot stall the caller. Each rank
takes its share of the host's cores for PyTorch's CPU threads."""

from __future__ import annotations

import multiprocessing
import os
import shutil
import socket
import tempfile
import time
import traceback

import torch
import torch.distributed as dist


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init(rank: int, world: int, port: int, backend: str = "gloo") -> None:
    """Join the default process group of `world` ranks at tcp://127.0.0.1:port."""
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank)


def _rank_main(fn, rank, world, port, backend, args, out_dir):
    path = os.path.join(out_dir, f"rank{rank}")
    # The ranks share the host's cores.
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        init(rank, world, port, backend)
        try:
            result = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        torch.save({"result": result}, path + ".pt")
    except BaseException:
        with open(path + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn(fn, world: int, *args, backend: str = "gloo", timeout: float = 600.0) -> list:
    """fn(rank, world, *args) on `world` spawned ranks; returns their results
    in rank order. fn must be importable (a module-level function)."""
    ctx = multiprocessing.get_context("spawn")
    out_dir = tempfile.mkdtemp(prefix="sps_ranks_")
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, port, backend, args, out_dir),
                         daemon=True) for r in range(world)]
    try:
        for p in procs:
            p.start()
        # Wait for every rank, or for the first that fails (its peers would
        # wait in a collective until the timeout).
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline and any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            time.sleep(0.05)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        errs = {}
        for r in range(world):
            err = os.path.join(out_dir, f"rank{r}.err")
            if os.path.exists(err):
                with open(err) as f:
                    errs[r] = f.read()
        if errs:
            raise RuntimeError("rank(s) failed:\n" + "\n".join(
                f"--- rank {r} ---\n{e}" for r, e in sorted(errs.items())))
        if hung:
            raise TimeoutError(f"ranks {hung} of {world} still running after {timeout} s")
        bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"ranks exited with codes {bad}")
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)["result"]
                for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        shutil.rmtree(out_dir, ignore_errors=True)
