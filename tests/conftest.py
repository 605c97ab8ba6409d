"""Registers the ``gpu`` marker: tests that need an NVIDIA card and skip
without one (the decision is made inside each test, never at import)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA card; skips with a reason without one")
