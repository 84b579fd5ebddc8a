"""Test session config. Tests run on the single real CPU device — only the
dry-run (and subprocess-isolated tests) request placeholder devices, per the
brief. `slow` marks the production-mesh compile test."""


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: production-mesh compile tests")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips (inside the test) without one")
