"""Settings every pytest process of this repository takes before any test
module is imported.

- torch's CPU threads: `threads_per_worker()`, the cores this process may
  use over the xdist workers (`PYTEST_XDIST_WORKER_COUNT`; 1 without
  xdist), rounded up, and at most 2. Rounded up, because much of a test's
  time is spent compiling JAX references or waiting on spawned ranks: the
  tier-1 run (`-n 6` on 8 cores) took 576 s at 2 threads a worker and
  781 s at 1. Tests that spawn ranks (`parallel.launch.run_local`) hand
  each rank the same count.
- JAX's CPU client runs each computation in the thread that dispatches it
  (`jax_cpu_enable_async_dispatch` off), where JAX is loaded (`tests/`
  conftest imports it; set before any test module builds the client). The
  TPU interpret mode of Pallas keeps one global simulated memory, so two
  interpreted kernels that run at once (two independent eager calls in a
  row, as the prev-clip blend makes) corrupt each other's state and can wait
  on each other for ever. Synchronous dispatch runs them one after the
  other. Nothing here imports JAX.
- Every test has `TEST_TIME_LIMIT_S`, many times the slowest test's time:
  past it faulthandler prints every thread's stack and ends the process, so
  a test that hangs fails (xdist starts another worker for the rest) and
  the run goes on to its end.
"""

import faulthandler
import os
import sys

import pytest

MAX_TEST_THREADS = 2
TEST_TIME_LIMIT_S = 600


def threads_per_worker() -> int:
    """torch's intra-op threads for a test process."""
    try:
        cores = len(os.sched_getaffinity(0))
    except AttributeError:
        cores = os.cpu_count() or 1
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, min(MAX_TEST_THREADS, -(-cores // max(workers, 1))))


def pytest_configure(config):
    import torch

    torch.set_num_threads(threads_per_worker())
    if "jax" in sys.modules:
        sys.modules["jax"].config.update("jax_cpu_enable_async_dispatch", False)


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item, nextitem):
    """The time limit over a test's set-up, call and teardown."""
    faulthandler.dump_traceback_later(TEST_TIME_LIMIT_S, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()
