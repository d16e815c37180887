"""One intra-op thread for the port's CPU tests (an autouse fixture that a
test module imports): their tensors are small, and the suite's workers
share a busy machine's cores."""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
