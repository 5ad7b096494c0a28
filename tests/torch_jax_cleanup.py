"""A fixture shared by the port's test files that run the JAX package:
each such module frees the XLA executables compiled while it ran, when
it ends.

Every compiled executable holds memory maps of its JIT code.  A test
worker that runs several compile-heavy files in a row (``test_sweep.py``,
``test_torch_commit.py`` and ``test_properties.py`` take about 66,000)
passes the kernel's limit of 65,530 maps per process
(``vm.max_map_count``), and the XLA compiler then crashes the worker.
``jax.clear_caches()`` drops the compiled executables; later modules
recompile what they use.  Import the fixture into a test module to
enable it there."""

import gc

import jax
import pytest


@pytest.fixture(scope="module", autouse=True)
def free_jax_executables():
    yield
    jax.clear_caches()
    gc.collect()
