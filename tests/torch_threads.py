"""A fixture for the port's CPU tests: one PyTorch thread a test.

The suite runs several pytest workers on the machine's cores, and PyTorch
gives each worker a thread pool as wide as the machine, so its OpenMP
threads oversubscribe the cores and small recurrent or convolutional ops
slow down by orders of magnitude. A test module opts in by importing the
fixture (it is autouse); the previous thread count is restored after each
test."""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
