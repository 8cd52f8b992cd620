"""The intra-op thread count of the port's heavier test modules. The tier-1
run keeps six test workers busy at once, where more threads a worker spin
against each other (a CLI test ran 50x slower than alone), and the tiny
models gain nothing from more. A module takes the fixture by importing it:

    from tests.test_torch_threads import _two_threads  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for the importing module; the previous count is
    restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_two_threads_in_module():
    assert torch.get_num_threads() == 2
