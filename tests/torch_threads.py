"""One intra-op torch thread for the port's CPU parity tests.

Their tensors are small, so more intra-op threads do not speed them up,
and under the tier-1 run's six pytest workers each extra thread only
oversubscribes the cores (a port step ran tens of times slower there than
alone).  A test module imports the fixture to use it:

    from tests.torch_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
