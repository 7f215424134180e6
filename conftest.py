"""Torch's thread count in every test process, decided here and nowhere else.

The test workers share the machine's cores: under pytest-xdist each worker
gets `cores // workers` intra-op threads, and a run without xdist gets them
all. Left at torch's default, every worker starts a pool as wide as the
machine, and the port's tests (many small ops on tiny grids) spend their
time in threads that spin and wait for each other: a spinning pool on tiny
ops costs more than it saves.

Only torch's own count is set, in this process. The environment
(`OMP_NUM_THREADS`, `XLA_FLAGS`, ...) stays as it is, so the JAX tests run as
before. A child process that a test starts is not reached from here: the
test sets the child's count where it needs one.
"""

import os


def torch_threads() -> int:
    """Intra-op threads for one test process: its cores over the workers."""
    cores = len(os.sched_getaffinity(0))
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, cores // workers)


def pytest_configure(config):
    # imported after the initial conftests, so that tests/conftest.py still
    # loads jax before anything loads torch
    import torch

    torch.set_num_threads(torch_threads())
