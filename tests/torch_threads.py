"""One intra-op thread for the port's CPU tests: the suite runs six test
files at once (xdist), and torch's own pool takes every core in each, so
that six pools spin against each other (a 4 s test measured 403 s).
Import the fixture into a test module to apply it there."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
