"""A module-scoped fixture that runs a test module's torch work on one
thread and restores the count after it.

The CPU suite runs several pytest workers side by side; each torch op of
the tiny configs the port's tool tests run is too small to gain from a
thread pool, which there only contends with the other workers.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
