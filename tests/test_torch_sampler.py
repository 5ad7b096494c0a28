"""The port's neighbor sampler (``repro_torch/models/sampler.py``) against
the JAX package's: ``build_csr``, ``block_shapes`` and ``sample_blocks``
give the same arrays, bit for bit, for the same inputs and ``rng``."""

import numpy as np
import pytest

from repro.models import sampler as jsampler
from repro_torch.models import sampler


def _graph(seed, n, e):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    return src, dst


def _same(a, b):
    assert type(a).__name__ == type(b).__name__
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y


@pytest.mark.parametrize("seed,n,e", [(0, 50, 400), (1, 300, 1000),
                                      (2, 1000, 200)])
def test_build_csr_bitwise(seed, n, e):
    src, dst = _graph(seed, n, e)
    _same(sampler.build_csr(src, dst, n), jsampler.build_csr(src, dst, n))


@pytest.mark.parametrize("batch,fanouts", [(1024, (15, 10)), (4, (3, 2)),
                                           (7, ()), (16, (5, 5, 5))])
def test_block_shapes(batch, fanouts):
    assert sampler.block_shapes(batch, fanouts) == \
        jsampler.block_shapes(batch, fanouts)


@pytest.mark.parametrize("seed,n,e,seeds,fanouts", [
    (0, 200, 3000, 8, (4, 3)),       # most degrees above the fanout
    (1, 500, 800, 16, (5, 2)),       # low degrees: take every neighbor
    (2, 60, 60, 10, (2, 2, 2)),      # isolated vertices, three hops
])
def test_sample_blocks_bitwise(seed, n, e, seeds, fanouts):
    src, dst = _graph(seed, n, e)
    g, jg = sampler.build_csr(src, dst, n), jsampler.build_csr(src, dst, n)
    picks = np.random.default_rng(seed + 10).choice(n, seeds, replace=False)
    got = sampler.sample_blocks(g, picks, fanouts,
                                np.random.default_rng(seed + 20))
    want = jsampler.sample_blocks(jg, picks, fanouts,
                                  np.random.default_rng(seed + 20))
    _same(got, want)
    n_max, e_max = sampler.block_shapes(seeds, fanouts)
    assert got.nodes.shape == (n_max,) and got.senders.shape == (e_max,)
