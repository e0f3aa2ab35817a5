"""Several ranks on one host, for tests and for one-card checks.

The JAX package's multi-device tests run on fake host devices inside one
process; a torch.distributed program needs one process per rank.
`run_local(world_size, fn, *args)` spawns them (the `spawn` start method, a
`file://` store in a fresh directory), calls `fn(*args)` on each rank after
`init_process_group`, and returns the ranks' results in rank order. The
first failure raises `RankError` naming the rank and carrying its
traceback; at `timeout` seconds every child is killed and `TimeoutError`
raised. Children are always reaped.

`fn` is pickled by its module path, so it must live in a module the children
can import (a module of this package, or the script that calls
`run_local`). The children import torch and this package only: a worker
module must not import JAX.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List


class RankError(RuntimeError):
    pass


def _child(rank: int, world_size: int, store: str, backend: str, threads: int,
           fn: Callable, args: tuple, results) -> None:
    try:
        import torch
        import torch.distributed as dist

        if threads:
            torch.set_num_threads(threads)
        dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                                world_size=world_size)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        # by value: a tensor sent through the queue's own pickler would travel
        # as a shared-memory handle that dies with this process
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def run_local(world_size: int, fn: Callable, *args, backend: str = "gloo",
              timeout: float = 300.0, threads: int = 2) -> List[Any]:
    """Run fn(*args) on `world_size` spawned ranks of one process group;
    returns [result of rank 0, ..., rank n-1]. `threads`: torch's intra-op
    threads per child (0 leaves torch's default)."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="vp_run_local_")
    store = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_child, args=(r, world_size, store, backend, threads, fn,
                                              args, results), daemon=True)
             for r in range(world_size)]
    out: List[Any] = [None] * world_size
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for _ in range(world_size):
            left = deadline - time.monotonic()
            try:
                r, ok, val = results.get(timeout=max(left, 0.01))
            except queue.Empty:
                dead = [i for i, p in enumerate(procs)
                        if not p.is_alive() and p.exitcode not in (0, None)]
                raise TimeoutError(f"run_local({world_size}, {getattr(fn, '__name__', fn)}) "
                                   f"timed out after {timeout:.0f} s; ranks that died "
                                   f"without a result: {dead}") from None
            if not ok:
                raise RankError(f"rank {r} of {world_size} failed in "
                                f"{getattr(fn, '__name__', fn)}:\n{val}")
            out[r] = pickle.loads(val)
        return out
    finally:
        for p in procs:
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
