"""A fixture the port's CPU tests share: import it into a test module with

    from _torch_threads import one_thread  # noqa: F401
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the module's tiny shapes: under pytest-xdist
    each worker's default (a thread a core) oversubscribes the CPU, and a
    run of tiny ops then waits on its threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
