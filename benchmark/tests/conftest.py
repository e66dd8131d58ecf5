import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    """The CUDA device, decided when the test runs: skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Several test workers share the CPU: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small_run(monkeypatch):
    """A run of a cell on the CPU: no warm requests, one judged request."""
    from benchmark.harness import infer

    monkeypatch.setattr(infer, "WARM_REQUESTS", 0)
    monkeypatch.setattr(infer, "SAMPLE_REQUESTS", 1)
