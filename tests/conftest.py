"""Registers the marker of tests that need an NVIDIA card."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card and nvcc; skips elsewhere "
        "(on the card: python -m pytest -m cuda tests/test_torch_cuda.py)")
