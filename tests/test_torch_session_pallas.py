"""The port's session against the JAX package's session on its Pallas
backend (interpret mode on the CPU) — the same matrix and contract as
test_torch_session.py, which holds the XLA backend; kept in its own module
so the two halves run on separate test workers."""

import pytest
import torch

from test_torch_session import MATRIX, MATRIX_IDS, check_session_matrix

torch.set_num_threads(1)


@pytest.mark.parametrize("family,n_cells,mli", MATRIX, ids=MATRIX_IDS)
def test_session_matches_reference_pallas(family, n_cells, mli):
    check_session_matrix(family, n_cells, mli, "pallas")
