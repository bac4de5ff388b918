"""One PyTorch intra-op thread for the port's CPU test modules.

The suite runs in several worker processes at once.  PyTorch's default of
one intra-op thread per core makes the workers' thread pools contend for
the cores, and the plain versions of the kernels (loops of small tensor
ops) then run several times slower, and slow the JAX tests beside them.
A port test module imports `one_torch_thread` (pytest's default import
mode puts `tests/` on the path, as it does for every module here); the
fixture restores the thread count when the module's tests are done.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_the_module_runs_on_one_thread():
    assert torch.get_num_threads() == 1
