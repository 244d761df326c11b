"""Shared fixture of the PyTorch port's CPU tests.

The port's tests run many small tensor ops; with torch's default
intra-op thread pool per process, the parallel test workers oversubscribe
the cores they share. Import ``one_torch_thread`` into a test module to
run that module's torch ops on one thread (restored afterwards)."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
