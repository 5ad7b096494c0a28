"""The port's push and auto sweeps of the sum programs (ppr, pagerank)
against the JAX package on both backends, within ``10 * eps`` — the
contract of test_torch_sweep.py, kept in its own module so the parts run
on separate test workers.  (Inside the port, push == pull bitwise for
these programs too: test_torch_sweep.py.)"""

import pytest
import torch

from test_torch_sweep import IDS, SUMS, check_reference, graphs
from torch_jax_cleanup import free_jax_executables  # noqa: F401 (autouse)

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=[False, True], ids=["clean", "dirty"])
def pair(request):
    return graphs(request.param)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("sweep", ["push", "auto"])
@pytest.mark.parametrize("name,kw", SUMS, ids=IDS(SUMS))
def test_sum_sweeps_match_reference(pair, name, kw, sweep, backend):
    check_reference(*pair, name, kw, sweep, backend)
