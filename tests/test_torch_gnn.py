"""The port's four GNNs (``repro_torch/models/gnn``) against the JAX
package's on the CPU in float32: ``apply``, ``loss_fn`` and the gradient
of every parameter leaf, with the reference's ``init_params`` weights
carried over by ``params_from_numpy`` and the same numpy-seeded graph.
Cases: with ``edge_mask`` / ``node_mask`` for every model, and without
for gatedgcn and meshgraphnet; for mace and equiformer-v2 also
``edge_chunks=4`` (the reference's chunked path: mace's scanned A-basis,
equiformer-v2's online softmax), ``channel_groups=4`` and
equiformer-v2's classification loss.  In the port, ``remat=True`` gives
``remat=False``'s loss and gradients bit for bit, with one edge chunk and
with 4 (the recompute sorts each chunk's receivers again).

Tolerances: outputs and loss 1e-5 abs + 1e-5 of the largest magnitude;
gradients 2e-5 abs + 1e-4 of the leaf's largest magnitude (two layers of
f32 products and segment sums, summed in other orders by XLA and torch).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.gnn import equiformer_v2 as jeqv2
from repro.models.gnn import gatedgcn as jgatedgcn
from repro.models.gnn import mace as jmace
from repro.models.gnn import meshgraphnet as jmgn
from repro.models.gnn.common import GraphBatch as JBatch
from repro_torch.models.gnn import equiformer_v2, gatedgcn, mace, meshgraphnet
from repro_torch.models.gnn.common import GraphBatch
from torch_jax_cleanup import free_jax_executables  # noqa: F401 (autouse)

OUT_TOL = 1e-5
GRAD_ATOL, GRAD_RTOL_OF_MAX = 2e-5, 1e-4
N, E, GRAPHS = 40, 160, 4

MODELS = {
    "gatedgcn": (jgatedgcn, gatedgcn, gatedgcn.GatedGCNConfig(
        n_layers=2, d_hidden=16, d_in=12, n_classes=4)),
    "meshgraphnet": (jmgn, meshgraphnet, meshgraphnet.MeshGraphNetConfig(
        n_layers=2, d_hidden=16)),
    "mace": (jmace, mace, mace.MACEConfig(
        n_layers=2, d_hidden=8, n_rbf=4, n_species=5)),
    "equiformer-v2": (jeqv2, equiformer_v2, equiformer_v2.EquiformerV2Config(
        n_layers=2, d_hidden=16, l_max=2, n_heads=2, n_species=5)),
}

# the variants at l_max 1 (5 CG paths, not 15): the reference's compile
# time grows with the paths, its code path does not change
L1 = {"l_max": 1}
EQ1 = {"l_max": 1, "m_max": 1}        # equiformer-v2 needs m_max <= l_max
CASES = [
    ("gatedgcn", "plain", {}), ("gatedgcn", "masked", {}),
    ("meshgraphnet", "plain", {}), ("meshgraphnet", "masked", {}),
    ("mace", "masked", {}),
    ("mace", "masked", {"edge_chunks": 4, **L1}),
    ("mace", "plain", {"channel_groups": 4, **L1}),
    ("equiformer-v2", "masked", {}),
    ("equiformer-v2", "masked", {"edge_chunks": 4, **EQ1}),
    ("equiformer-v2", "plain", {"channel_groups": 4, **EQ1}),
    ("equiformer-v2", "classes", {"d_out": 3, **EQ1}),
]


def _jax_cfg(jmod, cfg):
    """The reference's config with the port config's fields (float32)."""
    cls = next(v for k, v in vars(jmod).items() if k.endswith("Config"))
    return cls(**{f.name: getattr(cfg, f.name)
                  for f in dataclasses.fields(cfg) if f.name != "dtype"})


def _batch(arch, cfg, kind, seed=0):
    """The same graph for both packages as numpy arrays."""
    rng = np.random.default_rng(seed)
    rcv = rng.integers(0, N, E)
    rcv[:N] = np.arange(N)              # every node receives an edge
    b = {"senders": rng.integers(0, N, E).astype(np.int32),
         "receivers": rcv.astype(np.int32)}
    if kind == "masked":
        b["edge_mask"] = rng.random(E) < 0.8
        b["node_mask"] = rng.random(N) < 0.9
    n_graphs = 1
    if arch == "gatedgcn":
        b["nodes"] = rng.normal(size=(N, cfg.d_in)).astype(np.float32)
        b["labels"] = rng.integers(0, cfg.n_classes, N).astype(np.int32)
    elif arch == "meshgraphnet":
        b["nodes"] = rng.normal(size=(N, cfg.d_node_in)).astype(np.float32)
        b["edges"] = rng.normal(size=(E, cfg.d_edge_in)).astype(np.float32)
        b["labels"] = rng.normal(size=(N, cfg.d_out)).astype(np.float32)
    else:
        b["positions"] = rng.normal(size=(N, 3)).astype(np.float32)
        b["species"] = rng.integers(0, cfg.n_species, N).astype(np.int32)
        if kind == "classes":
            b["labels"] = rng.integers(0, cfg.d_out, N).astype(np.int32)
        else:
            n_graphs = GRAPHS
            b["graph_ids"] = np.sort(rng.integers(0, GRAPHS, N)).astype(
                np.int32)
            b["labels"] = rng.normal(size=(GRAPHS,)).astype(np.float32)
    return b, n_graphs


def _both(b, n_graphs):
    jb = JBatch(n_nodes=N, n_graphs=n_graphs,
                **{k: jnp.asarray(v) for k, v in b.items()})
    tb = GraphBatch(n_nodes=N, n_graphs=n_graphs,
                    **{k: torch.from_numpy(v) for k, v in b.items()})
    return jb, tb


def _port_loss_and_grads(tmod, params, tb, cfg):
    tree = params.requires_grad_(True).tree()
    leaves = jax.tree_util.tree_leaves(tree)
    loss = tmod.loss_fn(params, tb, cfg)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), grads


def _close(got, want, tol):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol + tol * float(np.abs(want).max()))


@pytest.mark.parametrize("arch,kind,over", CASES,
                         ids=[f"{a}-{k}-" + ("-".join(
                             f"{n}{v}" for n, v in o.items()) or "base")
                             for a, k, o in CASES])
def test_apply_loss_and_grads_match_reference(arch, kind, over):
    jmod, tmod, cfg = MODELS[arch]
    cfg = dataclasses.replace(cfg, **over)
    jcfg = _jax_cfg(jmod, cfg)
    b, n_graphs = _batch(arch, cfg, kind)
    jb, tb = _both(b, n_graphs)
    jp = jmod.init_params(jax.random.PRNGKey(1), jcfg)

    def both(p):
        return jmod.loss_fn(p, jb, jcfg), jmod.apply(p, jb, jcfg)
    (jl, jout), jg = jax.jit(jax.value_and_grad(both, has_aux=True))(jp)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    params = tmod.params_from_numpy(tree, cfg, device="cpu")
    with torch.no_grad():
        _close(tmod.apply(params, tb, cfg), jout, OUT_TOL)
    loss, grads = _port_loss_and_grads(tmod, params, tb, cfg)
    _close(loss, jl, OUT_TOL)
    flat = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert len(flat) == len(grads)
    for (path, w), g in zip(flat, grads):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, jax.tree_util.keystr(path)
        np.testing.assert_allclose(
            g.numpy(), w, rtol=0,
            atol=GRAD_ATOL + GRAD_RTOL_OF_MAX * float(np.abs(w).max()),
            err_msg=f"{arch} {kind} {over} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("chunks", [1, 4], ids=["remat", "remat_chunked"])
@pytest.mark.parametrize("arch", ["mace", "equiformer-v2"])
def test_variant_gives_the_same_loss_and_grads_bitwise(arch, chunks):
    """``remat=True`` against ``remat=False``, at 1 and 4 edge chunks."""
    _, tmod, cfg = MODELS[arch]
    b, n_graphs = _batch(arch, cfg, "masked", seed=2)
    _, tb = _both(b, n_graphs)
    cfg = dataclasses.replace(cfg, edge_chunks=chunks)
    over = {"remat": True}
    out = []
    for c in (cfg, dataclasses.replace(cfg, **over)):
        out.append(_port_loss_and_grads(
            tmod, tmod.init_params(c, seed=3, device="cpu"), tb, c))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


@pytest.mark.parametrize("arch", sorted(MODELS))
def test_params_trees_have_the_reference_leaves(arch):
    """``init_params`` draws the reference's tree (names, shapes), and
    ``params_to_numpy`` inverts ``params_from_numpy``."""
    jmod, tmod, cfg = MODELS[arch]
    jp = jax.tree_util.tree_map(np.asarray, jmod.init_params(
        jax.random.PRNGKey(0), _jax_cfg(jmod, cfg)))
    mine = tmod.init_params(cfg, seed=0, device="cpu").tree()
    want = jax.tree_util.tree_flatten_with_path(jp)[0]
    got = jax.tree_util.tree_flatten_with_path(mine)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    assert [tuple(t.shape) for _, t in got] == [a.shape for _, a in want]
    back = tmod.params_to_numpy(tmod.params_from_numpy(jp, cfg, "cpu"), cfg)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(a, b)
