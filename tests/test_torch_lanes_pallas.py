"""test_torch_lanes.py's reference check against the JAX package's Pallas
backend (interpret mode): its laned min/max runs the blocked kernel once
per lane, its laned ppr the scan kernel; the port's lanes take K2's plain
version either way and must agree bitwise for min/max (values, parents and
every ``DiffuseStats`` counter) and within ``10 * eps`` for ppr."""

import pytest

from test_torch_lanes import (  # noqa: F401  (graph: the shared fixture)
    IDS,
    REF_CASES,
    check_reference,
    graph,
)
from torch_jax_cleanup import free_jax_executables  # noqa: F401 (autouse)


@pytest.mark.parametrize("sweep", ["pull", "push"])
@pytest.mark.parametrize("name,kw", REF_CASES, ids=IDS(REF_CASES))
def test_lanes_match_reference_pallas(graph, name, kw, sweep):  # noqa: F811
    check_reference(graph, name, kw, 4, 4, sweep, "pallas")
