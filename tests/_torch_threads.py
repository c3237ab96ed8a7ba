"""One intra-op thread for the port's CPU tests of whole models.

The reduced models' ops are small: one intra-op thread runs them as fast
as PyTorch's pool does alone, and many times faster beside the suite's
other xdist workers, whose threads a pool per worker would contend with.
A test file imports the fixture by name, which makes it autouse there.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)
