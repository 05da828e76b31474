"""A module fixture for the port's test files: torch on one intra-op thread
while the module runs, restored afterwards.

The driver's command runs six pytest workers on eight cores. With torch's
default of a thread a core the workers' OpenMP regions oversubscribe the
cores, and the port's small eager steps ran 20-140 times slower than alone
(``tests/test_torch_sampling.py::test_cli_trains_then_samples``: 2.6 s
alone, 368.5 s in the full run). Import it into a test module:

    from torch_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
