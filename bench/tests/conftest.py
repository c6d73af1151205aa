"""The CPU tests run tiny tensors: one intra-op thread a process is
faster there, and leaves the cores to the other test workers."""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
