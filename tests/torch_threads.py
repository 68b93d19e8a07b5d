"""One torch CPU thread while a test module of the port runs.

The tier-1 command runs six pytest workers at once. Each process's torch
would otherwise start one intra-op thread per core, and six such pools on
the same cores spin against each other: a CPU training step that takes a
second alone took minutes that way. The port's tests run small shapes, for
which one thread is as fast alone. A module imports the fixture to use it;
it restores the count when the module ends.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
