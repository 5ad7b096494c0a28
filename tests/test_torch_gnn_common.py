"""The port's GNN message-passing blocks (``repro_torch/models/gnn/
common.py``) against the JAX package's, on the CPU in float32 with the
same numpy-seeded inputs: ``gather_scatter`` (sum, mean, max; with and
without an edge mask, through an ``edge_fn``), ``edge_softmax_agg`` (a
receiver whose edges are all masked included), ``layernorm_simple``,
``mlp_apply`` and the ``segment_sum`` helper, values and gradients
(``jax.grad`` of the same scalar).

Tolerance 1e-5 abs + 1e-5 of the largest magnitude: single f32 sums over
a few tens of rows each, in other orders in XLA and torch; ``max`` exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.gnn import common as jc
from repro_torch.models.gnn import common as tc
from torch_jax_cleanup import free_jax_executables  # noqa: F401 (autouse)

TOL = 1e-5
N, E, F = 37, 211, 6


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol + tol * float(np.abs(want).max()))


def _inputs(seed, masked):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, F)).astype(np.float32)
    snd = rng.integers(0, N, E).astype(np.int32)
    rcv = rng.integers(0, N, E).astype(np.int32)
    mask = (rng.random(E) < 0.8) if masked else None
    return x, snd, rcv, mask


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("combine", ["sum", "mean", "max"])
def test_gather_scatter_matches_reference(combine, masked):
    x, snd, rcv, mask = _inputs(1, masked)
    want = jc.gather_scatter(_j(x), _j(snd), _j(rcv), N, edge_mask=_j(mask),
                             combine=combine)
    got = tc.gather_scatter(_t(x), _t(snd), _t(rcv), N, edge_mask=_t(mask),
                            combine=combine)
    if combine == "max":        # empty segments are -inf on both sides
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        _close(got, want)


def test_gather_scatter_edge_fn():
    x, snd, rcv, mask = _inputs(2, True)
    w = np.random.default_rng(3).normal(size=(F, 4)).astype(np.float32)
    want = jc.gather_scatter(_j(x), _j(snd), _j(rcv), N,
                             edge_fn=lambda m: jnp.tanh(m @ _j(w)),
                             edge_mask=_j(mask))
    got = tc.gather_scatter(_t(x), _t(snd), _t(rcv), N,
                            edge_fn=lambda m: torch.tanh(m @ _t(w)),
                            edge_mask=_t(mask))
    _close(got, want)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_edge_softmax_agg_matches_reference(masked):
    rng = np.random.default_rng(4)
    h, c = 3, 5
    logits = rng.normal(size=(E, h)).astype(np.float32)
    values = rng.normal(size=(E, h, c)).astype(np.float32)
    rcv = rng.integers(0, N, E).astype(np.int32)
    mask = None
    if masked:
        mask = rng.random(E) < 0.7
        mask[rcv == 5] = False          # receiver 5: every edge masked
    want = jc.edge_softmax_agg(_j(logits), _j(values), _j(rcv), N,
                               edge_mask=_j(mask))
    got = tc.edge_softmax_agg(_t(logits), _t(values), _t(rcv), N,
                              edge_mask=_t(mask))
    _close(got, want)
    if masked:
        assert not got[5].any()


def test_edge_softmax_agg_gradient_matches_reference():
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(E, 2)).astype(np.float32)
    values = rng.normal(size=(E, 2, 3)).astype(np.float32)
    rcv = rng.integers(0, N, E).astype(np.int32)
    mask = rng.random(E) < 0.7
    co = rng.normal(size=(N, 2, 3)).astype(np.float32)

    def jloss(lg, v):
        return (jc.edge_softmax_agg(lg, v, _j(rcv), N, edge_mask=_j(mask))
                * _j(co)).sum()
    jg = jax.grad(jloss, argnums=(0, 1))(_j(logits), _j(values))
    lg, v = _t(logits).requires_grad_(), _t(values).requires_grad_()
    loss = (tc.edge_softmax_agg(lg, v, _t(rcv), N, edge_mask=_t(mask))
            * _t(co)).sum()
    tg = torch.autograd.grad(loss, (lg, v))
    for g, w in zip(tg, jg):
        assert bool(torch.isfinite(g).all())
        _close(g, w)


def test_layernorm_simple_and_mlp_apply():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(N, F)).astype(np.float32) * 3 + 1
    _close(tc.layernorm_simple(_t(x)), jc.layernorm_simple(_j(x)))
    tree = jax.tree_util.tree_map(
        np.asarray, jc.mlp_init(jax.random.PRNGKey(0), (F, 8, 8, 2)))
    layers_j = jax.tree_util.tree_map(jnp.asarray, tree)
    layers_t = [{k: _t(v) for k, v in l.items()} for l in tree]
    for kw in ({}, {"final_act": True}, {"norm_final": True}):
        _close(tc.mlp_apply(layers_t, _t(x), **kw),
               jc.mlp_apply(layers_j, _j(x), **kw))
    assert [tuple(l["w"].shape) for l in tc.mlp_init(
        torch.Generator().manual_seed(0), (F, 8, 8, 2))] == \
        [l["w"].shape for l in tree]


@pytest.mark.parametrize("shape", [(E,), (E, F), (E, 3, 4)],
                         ids=["1d", "2d", "3d"])
def test_segment_sum_value_and_gradient(shape):
    """The helper on CPU tensors against ``jax.ops.segment_sum``, and its
    gradient (a row gather) against ``jax.grad``; ids include the spare
    segment N that masked edges go to."""
    rng = np.random.default_rng(7)
    vals = rng.normal(size=shape).astype(np.float32)
    ids = rng.integers(0, N + 1, E).astype(np.int32)
    co = rng.normal(size=(N + 1,) + shape[1:]).astype(np.float32)
    want = jax.ops.segment_sum(_j(vals), _j(ids), num_segments=N + 1)
    jg = jax.grad(lambda v: (jax.ops.segment_sum(
        v, _j(ids), num_segments=N + 1)[:N] * _j(co)[:N]).sum())(_j(vals))
    v = _t(vals).requires_grad_()
    got = tc.segment_sum(v, _t(ids), N + 1)
    _close(got, want)
    (g,) = torch.autograd.grad((got[:N] * _t(co)[:N]).sum(), (v,))
    _close(g, jg)
    assert not g[torch.from_numpy(ids == N)].any()


@pytest.mark.parametrize("shape", [(E, F), (E, 3, 4)], ids=["2d", "3d"])
def test_one_sort_serves_several_sums(shape):
    """Ids sorted once (``ops.sort_ids``, as ``common.segments`` does on the
    card) serve two sums: ``ops.segment_sum_sorted_by`` (on CPU tensors
    K5's plain version of the kernel's own algorithm) and the helper given
    a ``Segments`` against ``jax.ops.segment_sum``, values and gradients,
    the spare segment N included."""
    from repro_torch.kernels.segment_reduce import ops

    rng = np.random.default_rng(11)
    ids = rng.integers(0, N + 1, E).astype(np.int32)
    s = ops.sort_ids(_t(ids), N + 1)
    seg = tc.segments(_t(ids), N + 1)
    assert seg.sorted is None                     # sorted only on the card
    for k in range(2):
        vals = rng.normal(size=shape).astype(np.float32)
        co = rng.normal(size=(N + 1,) + shape[1:]).astype(np.float32)
        want = jax.ops.segment_sum(_j(vals), _j(ids), num_segments=N + 1)
        jg = jax.grad(lambda v: (jax.ops.segment_sum(
            v, _j(ids), num_segments=N + 1) * _j(co)).sum())(_j(vals))
        for fn in (lambda v: ops.segment_sum_sorted_by(
                       v.reshape(E, -1), s).reshape(want.shape),
                   lambda v: tc.segment_sum(v, seg)):
            v = _t(vals).requires_grad_()
            got = fn(v)
            _close(got, want)
            (g,) = torch.autograd.grad((got * _t(co)).sum(), (v,))
            _close(g, jg)


def test_segment_sum_refuses_an_index_out_of_range():
    """No clamp hides a bad index on the CPU (JAX drops it silently)."""
    with pytest.raises(RuntimeError, match="out of bounds"):
        tc.segment_sum(torch.ones(4, 2), torch.tensor([0, 1, 2, 9]), 5)


def test_segment_max_empty_segments_are_minus_inf():
    got = tc.segment_max(torch.tensor([[1.0], [3.0], [2.0]]),
                         torch.tensor([0, 0, 2]), 4)
    want = jax.ops.segment_max(jnp.asarray([[1.0], [3.0], [2.0]]),
                               jnp.asarray([0, 0, 2]), num_segments=4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
