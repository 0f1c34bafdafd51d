"""Multi-process gloo worlds for the port's parallel tests, on the CPU.

``run_world(target, world_size, tmp_path, *args)`` spawns ``world_size``
processes; each starts the gloo process group by ``file://`` under
``tmp_path`` (so that concurrent test workers share no port), calls
``target(rank, *args)`` and saves what it returns to ``tmp_path``.  The
parent joins them with a timeout: a hung rank fails the test instead of
holding the suite's clock.  This module and the targets import no jax: the
ranks import the port only.
"""

import multiprocessing as mp
import sys
import time
import traceback
from pathlib import Path

import torch

JOIN_TIMEOUT = 120.0


def _entry(target, rank, world_size, out_dir, args):
    torch.set_num_threads(1)
    out = Path(out_dir)
    from trajectorycrafter_tpu_torch.parallel import distributed as D

    try:
        D.init("gloo", rank, world_size, f"file://{out / 'store'}", "cpu")
        result = target(rank, *args)
        torch.save(result, out / f"rank{rank}.pt")
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        sys.exit(1)
    finally:
        D.shutdown()


def run_world(target, world_size: int, tmp_path, *args, timeout: float = JOIN_TIMEOUT) -> list:
    """Each rank's return value of ``target(rank, *args)``, by rank."""
    out = Path(tmp_path) / f"world_{target.__name__}_{time.monotonic_ns()}"
    out.mkdir(parents=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(target, r, world_size, str(out), args))
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        if hung:
            raise TimeoutError(f"ranks {hung} of {world_size} still running after {timeout} s")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    errors = {r: (out / f"rank{r}.err").read_text() for r in range(world_size)
              if (out / f"rank{r}.err").exists()}
    if errors or any(p.exitcode for p in procs):
        raise RuntimeError(f"ranks failed (exit codes {[p.exitcode for p in procs]}):\n"
                           + "\n".join(f"rank {r}:\n{e}" for r, e in errors.items()))
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world_size)]
