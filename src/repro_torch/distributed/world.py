"""Spawn a ``torch.distributed`` world of local processes and collect
what each rank returns.

:func:`run_world` starts ``world_size`` processes (the ``spawn`` start
method, so a parent that holds the card can start them), rendezvoused
over ``tcp://127.0.0.1:<free port>``, each with ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT`` set as ``torchrun`` sets them, and calls ``fn(rank,
*args)`` in each after ``init_process_group`` (or, with ``init=False``,
leaves that to ``fn``, as ``launch/train.py`` does under ``torchrun``).
A rank that raises, dies or outlives ``timeout`` fails the whole world:
the parent kills every rank still running and raises, so a collective
waiting on a dead peer never holds the caller.  ``fn`` must be importable
by the child (a module-level function).
"""
from __future__ import annotations

import datetime
import os
import queue as queue_mod
import socket
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.multiprocessing as mp


def free_port() -> int:
    """A TCP port of 127.0.0.1 that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child(rank: int, world: int, port: int, backend: Optional[str],
           fn: Callable, inbox, out, timeout: float) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(1)            # ranks share the host's cores
    import torch.distributed as dist
    try:
        args = inbox.get()
        if backend is not None:
            dist.init_process_group(
                backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                world_size=world,
                timeout=datetime.timedelta(seconds=timeout))
        result = fn(rank, *args)
        out.put((rank, True, result))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_world(fn: Callable, world_size: int, args: Sequence = (), *,
              backend: Optional[str] = "gloo", timeout: float = 300.0
              ) -> List[Any]:
    """``[fn(0, *args), ..., fn(world_size − 1, *args)]``, each run in its
    own process of one world (``backend=None``: ``fn`` initializes the
    process group itself, from the environment).  Raises RuntimeError
    with the first failing rank's traceback, or TimeoutError after
    ``timeout`` seconds, having killed every rank."""
    ctx = mp.get_context("spawn")
    out, inbox = ctx.Queue(), ctx.Queue()
    port = free_port()
    # the arguments go through a queue, not the process objects: a spawn
    # blocks until the child has imported its main module and read what
    # it was handed, so large arguments would start the ranks one by one
    procs = [ctx.Process(target=_child, args=(
        r, world_size, port, backend, fn, inbox, out, timeout),
        daemon=True) for r in range(world_size)]
    results: dict = {}
    deadline = time.monotonic() + timeout
    error: Optional[BaseException] = None
    try:
        for p in procs:
            p.start()
        for _ in procs:
            inbox.put(tuple(args))
        while len(results) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                error = TimeoutError(
                    f"world of {world_size}: ranks "
                    f"{sorted(set(range(world_size)) - set(results))} did "
                    f"not finish within {timeout:.0f} s")
                break
            try:
                rank, ok, value = out.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode not in (None, 0)]
                if dead:
                    error = RuntimeError(
                        f"world of {world_size}: rank {dead[0]} died with "
                        f"exit code {procs[dead[0]].exitcode}")
                    break
                continue
            if not ok:
                error = RuntimeError(f"world of {world_size}: rank {rank} "
                                     f"raised:\n{value}")
                break
            results[rank] = value
    except BaseException as e:
        error = e
        raise
    finally:
        for p in procs:
            if error is not None and p.is_alive():
                p.kill()
            if p.pid is not None:
                p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        out.close()
        inbox.close()
    if error is not None:
        raise error
    return [results[r] for r in range(world_size)]
