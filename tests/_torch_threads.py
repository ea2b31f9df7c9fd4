"""One intra-op torch thread for a port test module: import its fixture
into the module (``from _torch_threads import one_torch_thread``).  The
tiny models gain nothing from more, and under the suite's parallel
workers idle spinning threads take the cores the other workers need."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
