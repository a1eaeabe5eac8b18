"""pytest settings of the benchmark's own tests (``rtbench/tests``):
``python3 -m pytest rtbench/tests -q`` from the repository root."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one (decided "
        "inside the test)")
