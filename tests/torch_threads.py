"""One torch intra-op thread while a test module runs.

The port's CPU tests are many small torch ops (solves, labs, sharded
applies); under the suite's six xdist workers each would otherwise run them
on as many spinning threads as the host has cores.  A test module takes it
by importing the fixture (autouse, module scope):

    from torch_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
