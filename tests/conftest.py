"""Pytest settings shared by the test files: marker registration only."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "requires_cuda: needs a CUDA device (and nvcc); skips without one",
    )
