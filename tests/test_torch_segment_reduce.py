"""K5 (sorted segment sum) and K6 (SSSP relaxation sweep) plain versions
against the JAX package's Pallas kernels in interpret mode (CPU).

K5 tolerance 1e-4 max abs (the reference's own sweep bound) on N(0, 1)
values: a segment's rows are summed in row order in the port and by a
one-hot matmul in the reference, and partials of segments spanning blocks
meet in another order.  K6 is a min, which is order-free: bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segment_reduce.ops import (
    segment_sum as jsegment_sum,
    segment_sum_presorted as jpresorted,
)
from repro.kernels.sssp_relax.ops import relax as jrelax
from repro_torch.kernels.segment_reduce import kernel as k5, ops as sops, ref
from repro_torch.kernels.sssp_relax import kernel as k6, ops as rops

TOL = 1e-4


@pytest.mark.parametrize("e,f,n", [(64, 8, 13), (1000, 32, 77),
                                   (257, 1, 300), (128, 128, 5)])
def test_segment_sum_matches_pallas_interpret(e, f, n):
    rng = np.random.default_rng(4)
    ids = rng.integers(0, n, e).astype(np.int32)
    vals = rng.normal(size=(e, f)).astype(np.float32)
    want = jsegment_sum(jnp.asarray(vals), jnp.asarray(ids), n,
                        backend="interpret")
    got = sops.segment_sum(torch.from_numpy(vals), torch.from_numpy(ids), n)
    assert got.shape == (n, f) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)
    oracle = ref.segment_sum_ref(torch.from_numpy(vals),
                                 torch.from_numpy(ids), n)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), atol=TOL, rtol=0)


def test_presorted_with_dropped_ids_matches_reference():
    """-1 ids (padding) and ids past N are dropped, as the reference's
    phase 2 drops them; runs spanning several 128-row blocks."""
    rng = np.random.default_rng(8)
    ids = np.sort(rng.integers(-1, 12, 700)).astype(np.int32)
    ids[-30:] = 40                        # past N = 12
    vals = rng.normal(size=(700, 4)).astype(np.float32)
    want = jpresorted(jnp.asarray(vals), jnp.asarray(ids), 12,
                      backend="interpret")
    got = sops.segment_sum_presorted(torch.from_numpy(vals),
                                     torch.from_numpy(ids), 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


def test_plain_kernel_sums_each_block_run_in_row_order():
    """A segment inside one block is the row-order sum of its rows, bit
    for bit (what the CUDA kernel computes per run)."""
    rng = np.random.default_rng(9)
    ids = torch.from_numpy(np.repeat(np.arange(8, dtype=np.int32), 16))
    vals = torch.from_numpy(rng.normal(size=(128, 3)).astype(np.float32))
    got = k5.segment_sum_sorted(vals, ids, 8)
    for s in range(8):
        acc = torch.zeros(3)
        for r in range(16 * s, 16 * s + 16):
            acc = acc + vals[r]
        assert torch.equal(got[s], acc)


def test_segment_sum_gradient_matches_reference():
    rng = np.random.default_rng(5)
    ids = np.sort(rng.integers(0, 10, 100)).astype(np.int32)
    ids[:3] = -1
    vals = rng.normal(size=(100, 4)).astype(np.float32)
    w = rng.normal(size=(10, 4)).astype(np.float32)

    def jloss(v):
        return (jsegment_sum(v, jnp.asarray(ids), 10, backend="interpret")
                * w).sum() + (jsegment_sum(v, jnp.asarray(ids), 10,
                                           backend="interpret") ** 2).sum()

    want = jax.grad(jloss)(jnp.asarray(vals))
    tv = torch.from_numpy(vals).requires_grad_()
    out = sops.segment_sum(tv, torch.from_numpy(ids), 10)
    ((out * torch.from_numpy(w)).sum() + (out ** 2).sum()).backward()
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)
    assert (tv.grad[torch.from_numpy(ids) < 0] == 0).all()


@pytest.mark.parametrize("np_,e", [(50, 200), (300, 900), (128, 512)])
def test_relax_matches_pallas_interpret_bitwise(np_, e):
    rng = np.random.default_rng(6)
    dist = np.where(rng.random(np_) < 0.4, rng.random(np_) * 10,
                    np.inf).astype(np.float32)
    active = rng.random(np_) < 0.5
    src = rng.integers(0, np_, e).astype(np.int32)
    dst = np.sort(rng.integers(0, np_, e)).astype(np.int32)
    dst[rng.random(e) < 0.1] = -1
    w = (rng.random(e) * 5).astype(np.float32)
    want = np.asarray(jrelax(*map(jnp.asarray, (dist, active, w, src, dst)),
                             np_, backend="interpret"))
    got = rops.relax(*map(torch.from_numpy, (dist, active, w, src, dst)), np_)
    assert got.dtype == torch.float32
    assert got.numpy().tobytes() == want.tobytes()
    assert k6.LAUNCHES["relax_sorted"] == 0        # CPU: no launch
