def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA card; skips (inside a fixture) "
        "where there is none")
