"""One torch thread for the port's CPU tests.

The suite runs in several processes at once (pytest-xdist). torch's own
intra-op pool defaults to one thread per core in each of them, and its
threads wait on each other for every small op: under that load a gradcheck
that takes 2 s alone takes minutes, and the spinning threads starve the
tests that run beside it. A test module imports ``one_torch_thread`` to run
its torch work on one thread and give the pool back afterwards."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
