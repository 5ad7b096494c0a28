"""K5 (sorted segment sum) and K6 (SSSP relaxation sweep) plain versions
against the JAX package's Pallas kernels in interpret mode (CPU).

K5 tolerance 1e-4 max abs (the reference's own sweep bound) on N(0, 1)
values: the port sums a segment's rows in row order within chunks of
``ref.CHUNK`` rows and folds the chunks' partials in order, the reference
by a one-hot matmul per 128-row block whose partials meet in its phase 2.
K5's plain version is held bitwise to a numpy loop of that fixed order.
K6 is a min, which is order-free: bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segment_reduce.kernel import (
    segment_sum_sorted as jsegment_sum_sorted,
)
from repro.kernels.segment_reduce.ops import (
    segment_sum as jsegment_sum,
    segment_sum_presorted as jpresorted,
)
from repro.kernels.sssp_relax.ops import relax as jrelax
from repro_torch.kernels.segment_reduce import kernel as k5, ops as sops, ref
from repro_torch.kernels.sssp_relax import kernel as k6, ops as rops
from torch_jax_cleanup import free_jax_executables  # noqa: F401 (autouse)

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
    """A segment of at most ``CHUNK`` rows is the row-order sum of its rows
    from 0, bit for bit; a longer one is its ``CHUNK``-row groups' row-order
    sums added in order (one level more past ``CHUNK**2`` rows): what the
    CUDA kernel computes per (segment, column)."""
    rng = np.random.default_rng(9)
    c = ref.CHUNK
    lens = [16, 0, c, c + 1, 3 * c + 5, 1]
    ids = torch.from_numpy(np.repeat(np.arange(6, dtype=np.int32), lens))
    vals = torch.from_numpy(rng.normal(size=(sum(lens), 3)).astype(
        np.float32))
    got = k5.segment_sum_sorted(vals, ids, 6)
    r = 0
    for s, ln in enumerate(lens):
        groups = []
        for g0 in range(0, max(ln, 1), c):
            acc = torch.zeros(3)
            for i in range(r + g0, r + min(g0 + c, ln)):
                acc = acc + vals[i]
            groups.append(acc)
        want = torch.zeros(3)
        for g in groups:
            want = want + g
        assert torch.equal(got[s], want), s
        r += ln


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


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _fixed_order(vals, ids, n, chunk):
    """numpy, one item at a time: each segment's rows cut into groups of
    ``chunk`` from its first row, each a float32 sum from 0 in order; while
    more than one group is left, the groups' sums grouped and summed the
    same way (an empty segment is 0)."""
    out = np.zeros((n, vals.shape[1]), np.float32)
    for s in range(n):
        items = [vals[r] for r in np.flatnonzero(ids == s)]
        while True:
            sums = []
            for g0 in range(0, max(len(items), 1), chunk):
                acc = np.zeros(vals.shape[1], np.float32)
                for x in items[g0:g0 + chunk]:
                    acc = acc + x
                sums.append(acc)
            items = sums
            if len(items) == 1:
                break
        out[s] = items[0]
    return out


def _stream(rng, f, dtype, hub):
    """Sorted ids: 5 dropped -1s first, 40 segments of 0-3 rows (empty
    ones among them) with segment 17 of ``hub`` rows, 4 ids >= N, then 6
    -1 pads at the tail (as the reference pads to its blocks)."""
    lens = rng.integers(0, 4, 40)
    lens[17] = hub
    ids = np.concatenate([np.full(5, -1), np.repeat(np.arange(40), lens),
                          np.full(4, 42), np.full(6, -1)]).astype(np.int32)
    vals = torch.from_numpy(rng.normal(size=(len(ids), f)).astype(
        np.float32)).to(dtype)
    return ids, vals, 40


@pytest.mark.parametrize("chunk", [ref.CHUNK, 5])
@pytest.mark.parametrize("f", [1, 3, 70])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_version_is_the_fixed_order(dtype, f, chunk):
    """The plain version (vectorized over groups) is bitwise a numpy loop
    of the kernel's order, rounded once to the values' dtype, on a ragged
    stream with -1 at both ends, ids >= N, empty segments and one segment
    longer than the group (at ``chunk`` 5: four levels); the entry point
    on CPU tensors is it."""
    rng = np.random.default_rng(f + chunk)
    ids, vals, n = _stream(rng, f, dtype, 2 * ref.CHUNK + 7)
    t_ids = torch.from_numpy(ids)
    got = ref.segment_sum_sorted_ref(vals, t_ids, n, chunk=chunk)
    want = torch.from_numpy(_fixed_order(vals.float().numpy(), ids, n,
                                         chunk)).to(dtype)
    assert got.dtype == dtype and got.shape == (n, f)
    assert torch.equal(_bits(got), _bits(want))
    if chunk == ref.CHUNK:
        n0 = k5.LAUNCHES["segment_sum_sorted"]
        entry = k5.segment_sum_sorted(vals, t_ids, n)
        assert torch.equal(_bits(entry), _bits(want))
        assert k5.LAUNCHES["segment_sum_sorted"] == n0       # CPU: no launch


def test_plain_version_edge_cases():
    """N = 0 gives [0, F]; E = 0 gives zeros (+0.0, every element); F = 1
    over one segment of more than ``CHUNK**2`` rows (a one-graph pool:
    three levels of groups)."""
    ids = torch.tensor([-1, 0, 1, 2, 3], dtype=torch.int32)
    assert k5.segment_sum_sorted(torch.ones(5, 3), ids, 0).shape == (0, 3)
    empty = k5.segment_sum_sorted(torch.zeros(0, 4, dtype=torch.bfloat16),
                                  torch.zeros(0, dtype=torch.int32), 3)
    assert empty.shape == (3, 4) and empty.dtype == torch.bfloat16
    assert not _bits(empty).any()
    s = sops.sort_ids(torch.zeros(0, dtype=torch.int64), 2)
    assert s.offsets.tolist() == [0, 0, 0]
    assert not sops.segment_sum_sorted_by(torch.zeros(0, 2), s).any()
    rng = np.random.default_rng(3)
    rows = ref.CHUNK ** 2 + 3 * ref.CHUNK + 1
    pool = rng.normal(size=(rows, 1)).astype(np.float32)
    got = k5.segment_sum_sorted(torch.from_numpy(pool),
                                torch.zeros(rows, dtype=torch.int32), 1)
    want = _fixed_order(pool, np.zeros(rows, np.int32), 1, ref.CHUNK)
    assert _bits(got).numpy().tobytes() == want.view(np.int32).tobytes()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sorted_by_fuses_the_gather_bitwise(dtype):
    """``segment_sum_sorted_by`` reads the rows in ``order`` itself: bitwise
    the plain sum of ``values[order]`` (no copy of the values); the row
    pointer is ``ref.row_offsets`` of the sorted ids, and the sort carries
    no padding."""
    rng = np.random.default_rng(12)
    n = 300
    ids = rng.integers(0, n + 1, 1500)
    ids[rng.random(1500) < 0.15] = n                  # a hub: masked edges
    ids = torch.from_numpy(ids)
    vals = torch.from_numpy(rng.normal(size=(1500, 70)).astype(
        np.float32)).to(dtype)
    s = sops.sort_ids(ids, n + 1)
    assert s.order.dtype == s.sorted_ids.dtype == torch.int32
    assert s.order.shape == s.sorted_ids.shape == (1500,)
    assert torch.equal(s.offsets, ref.row_offsets(s.sorted_ids, n + 1))
    got = sops.segment_sum_sorted_by(vals, s)
    want = ref.segment_sum_sorted_ref(vals[s.order.long()], s.sorted_ids,
                                      n + 1)
    assert got.dtype == dtype
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(sops.segment_sum(vals, ids, n + 1)),
                       _bits(want))


@pytest.mark.parametrize("f", [1, 70])
def test_any_e_matches_pallas_interpret_padded(f):
    """The port takes any E; the reference's kernel takes E % 128 == 0, so
    its side is padded with -1 ids: the plain version and the fused sum of
    the same stream shuffled both within TOL of it (a segment of three
    groups, -1 first, ids >= N last)."""
    rng = np.random.default_rng(f)
    ids, vals, n = _stream(rng, f, torch.float32, 3 * ref.CHUNK)
    ids, vals = ids[:-6], vals[:-6]                   # no tail pad here
    pad = (-len(ids)) % 128
    want = np.asarray(jsegment_sum_sorted(
        jnp.asarray(np.pad(vals.numpy(), ((0, pad), (0, 0)))),
        jnp.asarray(np.pad(ids, (0, pad), constant_values=-1)), n,
        interpret=True))
    got = k5.segment_sum_sorted(vals, torch.from_numpy(ids), n)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    perm = torch.from_numpy(rng.permutation(len(ids)))
    fused = sops.segment_sum(vals[perm], torch.from_numpy(ids)[perm], n)
    np.testing.assert_allclose(fused.numpy(), want, atol=TOL, rtol=0)


def test_k5_contract_is_checked_on_both_devices():
    """The wrapper refuses, before any dispatch, what the kernel does not
    take: strided columns (it never copies), another dtype, int64 ids; the
    kernel's chunk is the plain version's."""
    from pathlib import Path

    ids = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="contiguous"):
        k5.segment_sum_sorted(torch.ones(4, 8).t(), ids, 2)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        k5.segment_sum_sorted(torch.ones(8, 4, dtype=torch.float64), ids, 2)
    with pytest.raises(TypeError, match="int32"):
        k5.segment_sum_sorted(torch.ones(8, 4), ids.long(), 2)
    strided = torch.ones(8, 6)[:, 1:5]                # rows 6 apart: taken
    assert torch.equal(k5.segment_sum_sorted(strided, ids, 2)[0],
                       torch.full((4,), 8.0))
    src = (Path(k5.__file__).parent / "csrc" / "segment_sum_sorted.cu")
    assert f"constexpr int kChunk = {ref.CHUNK};" in src.read_text()


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
