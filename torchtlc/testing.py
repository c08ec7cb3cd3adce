"""Settings shared by the port's CPU tests.

The tests run several pytest workers side by side on one host; torch's
intra-op thread pool would give each of them a thread per core, so the
workers oversubscribe the cores and slow one another.  ``one_thread()``
pins this process to one intra-op thread; ``subprocess_env()`` is the
environment for a command a test starts, with the same limit for OpenMP.
"""

from __future__ import annotations

import os


def one_thread() -> None:
    """One intra-op thread for torch in this process."""
    import torch

    torch.set_num_threads(1)


def subprocess_env() -> dict:
    """os.environ plus OMP_NUM_THREADS=1."""
    return dict(os.environ, OMP_NUM_THREADS="1")
