"""The module-scoped fixture that holds torch to one thread, shared by the
port's CPU test files (`tests/test_torch_*.py`). A file takes it with

    from _torch_threads import _one_torch_thread  # noqa: F401

which makes it autouse for that file's module."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU work in one thread: the suite runs in several worker
    processes at once, and torch's default of one thread per core in each
    oversubscribes the host many times over (a full-width run then takes
    tens of times longer than alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
