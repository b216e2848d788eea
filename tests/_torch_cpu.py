"""A fixture for the port's CPU tests: one intra-op torch thread per test
module. The port's tensors are small, and torch's thread pool costs more
than it brings on them, the more so when other processes share the cores:
a 2-step full-Newton rollout of the small bench scene took 6.9 s on one
thread and 31.5 s on eight (tests/test_torch_stepper.py's hess_refresh=1
case, on an 8-core CPU).

    from _torch_cpu import one_torch_thread  # noqa: F401  (autouse)
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
