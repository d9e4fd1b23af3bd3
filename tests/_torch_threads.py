"""The port's test files run torch on two intra-op threads.

The tier-1 run spreads the test files over six worker processes on one
machine; left alone, each worker's torch would start as many threads as the
machine has cores. Each of the port's ``tests/test_torch_*.py`` files imports
:func:`torch_threads`, an autouse fixture that caps torch's intra-op
threads for the file and restores the count after it.
"""

import pytest
import torch

THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(before)
