import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA GPU (the test skips without one)")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def sanitize():
    """The runtime sanitizer harness (repro.analysis.sanitize) as a
    fixture: ``with sanitize() as rep: ...`` runs the block under
    jax.transfer_guard('disallow') plus the hot-path jit cache-miss
    counter, raising RetraceError on clean exit if anything retraced."""
    from repro.analysis import sanitize as _sanitize

    return _sanitize
