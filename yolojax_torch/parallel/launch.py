"""Run a function on several ranks of a fresh process group, one spawned
process each, and collect what each returns.

    results = launch.run(fn, 2, args=(...), device="cpu", timeout=120)

Each process takes one thread of intra-op parallelism (``threads``), joins
a group at a free localhost port (bound to port 0 first) with ``backend``
(default: ``nccl`` on the card, ``gloo`` on the CPU; ``group=False``
joins none), calls ``fn(rank, *args)`` and sends its return value back
(it must pickle; ``fn`` must be importable by name, as spawned processes
import it). A rank that raises,
or any that is still running after ``timeout`` seconds, fails the call:
every process is killed and the error names the rank. No process
outlives the call.
"""

from __future__ import annotations

import multiprocessing as mp
import queue as queue_mod
import socket
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child(fn, rank: int, world: int, port: int, args: Sequence, device,
           backend: Optional[str], threads: int, group: bool, out) -> None:
    import torch

    from yolojax_torch.parallel import distributed

    torch.set_num_threads(threads)
    try:
        if group:
            distributed.initialize(f"127.0.0.1:{port}", world, rank,
                                   backend=backend, device=device)
        out.put((rank, True, fn(rank, *args)))
    except BaseException:  # report, so the parent need not wait it out
        out.put((rank, False, traceback.format_exc()))
        raise
    finally:
        distributed.shutdown()


def run(fn: Callable, world: int, *, args: Sequence = (), device=None,
        backend: Optional[str] = None, timeout: float = 120.0,
        threads: int = 1, group: bool = True) -> List[Any]:
    """``[fn(0, *args), ..., fn(world - 1, *args)]``, each in its own
    process of one ``world``-rank group."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_child,
                         args=(fn, r, world, port, tuple(args), device,
                               backend, threads, group, out), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results: dict = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"ranks {sorted(set(range(world)) - set(results))} still "
                    f"running after {timeout:.0f} s")
            try:
                rank, ok, value = out.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    raise RuntimeError(
                        f"rank {dead[0]} exited with code "
                        f"{procs[dead[0]].exitcode} and no result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            results[rank] = value
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(5)
        out.close()
    return [results[r] for r in range(world)]
