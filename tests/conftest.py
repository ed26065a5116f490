import numpy as np
import pytest

try:
    from hypothesis import HealthCheck, settings
except ModuleNotFoundError:  # minimal env: property tests auto-skip via _hyp
    settings = None

if settings is not None:
    # Single-core CPU container + jit compiles inside properties: disable deadlines.
    settings.register_profile(
        "repro",
        deadline=None,
        max_examples=15,
        suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large],
        derandomize=True,
    )
    settings.load_profile("repro")


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running test")
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA card; skips (inside a fixture) "
        "where there is none")


@pytest.fixture
def rng():
    return np.random.default_rng(0)
