"""The port's CPU tests run torch on one intra-op thread: their tensors are
tiny and gain little from more (0.19 s against 0.13 s for a 4-step heun
alone), and the tier-1 run's six workers on the host's cores spin each
other's thread pools (on an 8-core host, ``test_torch_models.py::
test_deep_transformers_are_refused`` took 3.97 s alone with a thread a
core and 38.8 s inside the six-worker run).  A test module imports the
fixture to take it:

    from tests.torch_threads import one_thread  # noqa: F401
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
