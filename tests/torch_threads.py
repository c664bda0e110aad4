"""One torch intra-op thread for a test module (test helper, not a test file).

The tier-1 run starts six pytest workers on the host's cores, and torch gives each worker one
intra-op thread per core; several port test files training small models at once then
oversubscribe the cores, and their OpenMP threads slow each other down by an order of
magnitude. A module that uses this fixture runs its torch work on one thread and restores the
worker's setting after it. Results do not depend on the thread count beyond summation order.
"""
import pytest
import torch


@pytest.fixture(scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
