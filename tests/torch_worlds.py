"""Multi-process gloo worlds for the port's parallel tests, on the CPU.

``run_world(target, world_size, tmp_path, *args)`` spawns ``world_size``
processes; each starts the gloo process group by ``file://`` under
``tmp_path`` (so that concurrent test workers share no port), calls
``target(rank, *args)`` and saves what it returns to ``tmp_path``.  The
parent polls them with a timeout: a hung rank fails the test instead of
holding the suite's clock, and a rank that fails ends the others at once
(or after ``linger`` seconds, for a test of how the others end), so that
ranks left waiting for it do not hold the clock either.  This module and
the targets import no jax: the ranks import the port only.
"""

import multiprocessing as mp
import sys
import time
import traceback
from pathlib import Path

import torch

JOIN_TIMEOUT = 120.0
POLL = 0.05  # seconds between looks at the ranks


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


def run_world(target, world_size: int, tmp_path, *args, timeout: float = JOIN_TIMEOUT,
              linger: float = 0.0) -> list:
    """Each rank's return value of ``target(rank, *args)``, by rank.  The
    ranks are polled: once one exits with an error the others get
    ``linger`` seconds to end on their own (0: none, they are ended at
    once), and the call raises with the first failed rank's error first."""
    out = Path(tmp_path) / f"world_{target.__name__}_{time.monotonic_ns()}"
    out.mkdir(parents=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(target, r, world_size, str(out), args))
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    first = None  # the first rank seen to fail
    try:
        while any(p.is_alive() for p in procs):
            if first is None:
                failed = [r for r, p in enumerate(procs) if p.exitcode]
                if failed:
                    first = failed[0]
                    deadline = min(deadline, time.monotonic() + linger)
            if time.monotonic() >= deadline:
                break
            time.sleep(POLL)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        if hung and first is None:
            raise TimeoutError(f"ranks {hung} of {world_size} still running after {timeout} s")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    errors = {r: (out / f"rank{r}.err").read_text() for r in range(world_size)
              if (out / f"rank{r}.err").exists()}
    codes = [p.exitcode for p in procs]
    if errors or any(codes):
        order = sorted(errors, key=lambda r: r != first)
        raise RuntimeError(f"ranks failed (exit codes {codes}; rank {first} first):\n"
                           + "\n".join(f"rank {r}:\n{errors[r]}" for r in order))
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world_size)]


def fail_at_once(rank, failing_rank, wait):
    """A target for the worlds' own test: ``failing_rank`` raises at once;
    the others wait ``wait`` seconds, as ranks wait in a collective for a
    peer that never comes.  Here, not with the other targets, so that the
    ranks start without importing the port's models."""
    if rank == failing_rank:
        raise RuntimeError(f"planted failure on rank {rank}")
    time.sleep(wait)
