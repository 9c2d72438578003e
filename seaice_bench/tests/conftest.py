"""The benchmark's tests: ``python -m pytest seaice_bench/tests -q`` (CPU,
about a minute); the card's: ``python -m pytest -m cuda seaice_bench/tests``."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the benchmark measures the port on the card")
    return torch.device("cuda:0")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
