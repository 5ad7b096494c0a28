"""The port's push and auto sweeps against the JAX package's Pallas backend
(the push kernel ``edge_relax_push_blocks`` in interpret mode on the CPU)
— the contract of test_torch_sweep.py, kept in its own module so the
halves run on separate test workers."""

import pytest
import torch

from test_torch_sweep import IDS, MINMAX, check_reference, graphs
from torch_jax_cleanup import free_jax_executables  # noqa: F401 (autouse)

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=[False, True], ids=["clean", "dirty"])
def pair(request):
    return graphs(request.param)


@pytest.mark.parametrize("sweep", ["push", "auto"])
@pytest.mark.parametrize("name,kw", MINMAX, ids=IDS(MINMAX))
def test_sweeps_match_reference_pallas(pair, name, kw, sweep):
    check_reference(*pair, name, kw, sweep, "pallas")
