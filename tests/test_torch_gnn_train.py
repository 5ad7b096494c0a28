"""The port's GNN training path against the JAX package's (CPU, float32):
every GNN cell of ``launch/steps.py`` (4 architectures x 4 shapes, built
without allocating) with the reference's input specs and config fields,
one adamw step of each architecture's smoke cell equal to the reference
cell's ``step`` on the same weights and batch, the port's seeded batches
inside their index ranges (the reference's are not), the
``repro_torch.launch.train`` CLI, and a GNN snapshot written by the port
equal, file for file and byte for byte, to the reference's.

Tolerances: loss 1e-5 abs + 2e-6 of its magnitude (a mace energy loss is
~10^3: a few f32 ulps); grad norm 1e-4 relative; parameters after the
step 2e-5 abs + 1e-4 of the leaf's largest magnitude (adamw's first update
is about lr * sign(g), so a gradient that rounds differently near zero
moves its element by a fraction of lr = 1e-3 at most).
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs.shapes import GNN_SHAPES as J_GNN_SHAPES
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models.gnn.common import GraphBatch as JBatch
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import registry
from repro_torch.configs.shapes import GNN_SHAPES
from repro_torch.launch import steps, train
from repro_torch.models.gnn.common import GraphBatch
from torch_jax_cleanup import free_jax_executables  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
GNN_ARCHS = ["gatedgcn", "meshgraphnet", "mace", "equiformer-v2"]
CELLS = [(a, s) for a in GNN_ARCHS for s in GNN_SHAPES]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int32": torch.int32, "bool": torch.bool}


def _jdtype(d) -> torch.dtype:
    return DTYPES[np.dtype(d).name]


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_cells_match_the_reference(arch, shape):
    jcell = jsteps.build_cell(arch, shape)
    cell = steps.build_cell(arch, shape, device="cpu")
    assert (cell.family, cell.mode) == (jcell.family, jcell.mode)
    jcfg, cfg = jcell.config, cell.config
    assert type(cfg).__name__ == type(jcfg).__name__
    names = {f.name for f in dataclasses.fields(jcfg)}
    assert {f.name for f in dataclasses.fields(cfg)} == names
    for name in names:
        want = getattr(jcfg, name)
        if name == "dtype":
            assert getattr(cfg, name) == _jdtype(want)
        else:
            assert getattr(cfg, name) == want, name
    jspec, spec = jcell.input_specs(), cell.input_specs()
    assert (spec.n_nodes, spec.n_graphs) == (jspec.n_nodes, jspec.n_graphs)
    want = {k: getattr(jspec, k) for k in spec.fields()}
    assert {k for k in want if want[k] is not None} == set(spec.fields())
    for name, s in spec.fields().items():
        assert s.shape == want[name].shape, name
        assert s.dtype == _jdtype(want[name].dtype), name
    assert dataclasses.astuple(GNN_SHAPES[shape]) == \
        dataclasses.astuple(J_GNN_SHAPES[shape])


def _both_batches(cell):
    host = train.gnn_batch(cell, seed=3)
    jb = JBatch(n_nodes=host.n_nodes, n_graphs=host.n_graphs,
                **{k: jnp.asarray(v) for k, v in host.fields().items()})
    tb = host.map(torch.from_numpy)
    return jb, tb


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_train_step_matches_reference(arch):
    shape = "molecule" if arch in ("mace", "equiformer-v2") else \
        "full_graph_sm"
    jcell = jsteps.build_cell(arch, shape, smoke=True)
    cell = steps.build_cell(arch, shape, smoke=True, device="cpu")
    jp = jcell.init_params(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    model = steps._GNN_MODELS[arch]
    params = model.params_from_numpy(tree, cell.config, device="cpu")
    jb, tb = _both_batches(cell)
    jp2, _, jm = jax.jit(jcell.step)(jp, jcell.init_opt(jp), 0, jb)
    params, state, m = cell.step(params, cell.init_opt(params), 0, tb)
    assert abs(float(m["loss"]) - float(jm["loss"])) <= \
        1e-5 + 2e-6 * abs(float(jm["loss"]))
    assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= \
        1e-4 * float(jm["grad_norm"])
    flat = jax.tree_util.tree_flatten_with_path(jp2)[0]
    got = jax.tree_util.tree_leaves(params.tree())
    assert len(flat) == len(got)
    for (path, w), g in zip(flat, got):
        w = np.asarray(w)
        np.testing.assert_allclose(
            g.detach().numpy(), w, rtol=0,
            atol=2e-5 + 1e-4 * float(np.abs(w).max()),
            err_msg=jax.tree_util.keystr(path))
    assert jax.tree_util.tree_structure(state) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(
            lambda _: 0, jcell.init_opt(jp)))


@pytest.mark.parametrize("arch,shape,smoke", [
    ("gatedgcn", "full_graph_sm", False), ("gatedgcn", "minibatch_lg", True),
    ("meshgraphnet", "full_graph_sm", True), ("mace", "molecule", False),
    ("mace", "full_graph_sm", True), ("equiformer-v2", "molecule", False),
    ("equiformer-v2", "full_graph_sm", False)])
def test_data_for_indices_are_in_range(arch, shape, smoke):
    cell = steps.build_cell(arch, shape, smoke=smoke, device="cpu")
    stream = train.data_for(cell)
    batch = next(stream)
    assert next(stream) is batch          # one fixed batch, fed again
    spec, cfg = cell.input_specs(), cell.config
    for name, s in spec.fields().items():
        got = getattr(batch, name)
        assert got.shape == s.shape and DTYPES[got.dtype.name] == s.dtype
    n = spec.n_nodes
    for name in ("senders", "receivers"):
        assert 0 <= getattr(batch, name).min() and \
            getattr(batch, name).max() < n
    if batch.species is not None:
        assert 0 <= batch.species.min() and \
            batch.species.max() < cfg.n_species
    if batch.graph_ids is not None:
        assert batch.graph_ids.max() < spec.n_graphs
    if batch.labels.dtype == np.int32:
        classes = getattr(cfg, "n_classes", None) or cfg.d_out
        assert 0 <= batch.labels.min() and batch.labels.max() < classes
    # masks over the real nodes and edges, padding after them
    n_real, e_real = int(batch.node_mask.sum()), int(batch.edge_mask.sum())
    assert batch.node_mask[:n_real].all() and batch.edge_mask[:e_real].all()
    assert (batch.receivers[e_real:] == 0).all()
    # the device copy is made once and handed out again
    moved = train.on_device(iter([batch, batch]), "cpu")
    first = next(moved)
    assert next(moved) is first and isinstance(first, GraphBatch)
    assert torch.equal(first.senders, torch.from_numpy(batch.senders))


@pytest.mark.parametrize("arch,shape,smoke", [
    ("gatedgcn", "full_graph_sm", False), ("mace", "molecule", False),
    ("equiformer-v2", "molecule", False), ("equiformer-v2", "full_graph_sm",
                                           False),
    ("equiformer-v2", "molecule", True), ("mace", "full_graph_sm", True)])
def test_data_for_gives_every_real_node_an_edge(arch, shape, smoke):
    """A full-graph or molecule batch: every real node receives an edge
    from another node of its graph, inside the 5.0 cutoff (equiformer-v2's
    gradient overflows on a node that receives nothing: ROADMAP queue 3);
    the real counts are the shape's (cut to a smoke cell's sizes)."""
    cell = steps.build_cell(arch, shape, smoke=smoke, device="cpu")
    batch = next(train.data_for(cell))
    em, nm = batch.edge_mask, batch.node_mask
    snd, rcv = batch.senders[em], batch.receivers[em]
    assert np.array_equal(np.unique(rcv), np.flatnonzero(nm))
    assert (snd != rcv).all() and nm[snd].all()
    g = GNN_SHAPES[shape]
    per = cell.input_specs().n_graphs
    if not smoke:
        assert (nm.sum(), em.sum()) == (g.n_nodes * per, g.n_edges * per)
    if batch.graph_ids is not None:
        assert (batch.graph_ids[snd] == batch.graph_ids[rcv]).all()
    if batch.positions is not None:
        r = np.linalg.norm(batch.positions[rcv] - batch.positions[snd],
                           axis=-1)
        assert r.max() < cell.config.r_cut and r.min() > 1e-6


def test_tree_block_is_what_the_sampler_draws_from_a_tree():
    """``train.tree_block`` (a sampled cell's default graph) equals
    ``sample_blocks`` on a graph where each node's out-edges are exactly
    the fanout and no node is reached twice."""
    from repro_torch.models import sampler

    seeds, fanout = 3, (4, 2)
    want = train.tree_block(seeds, fanout)
    # node v of hop h points at its children, numbered as the tree numbers
    # them; the last hop's nodes point nowhere
    src = want.receivers
    dst = want.senders
    g = sampler.build_csr(src, dst, want.n_real)
    blk = sampler.sample_blocks(g, np.arange(seeds), fanout,
                                np.random.default_rng(0))
    got = train.block_structure(blk)
    assert got.n_real == want.n_real
    np.testing.assert_array_equal(got.senders, want.senders)
    np.testing.assert_array_equal(got.receivers, want.receivers)
    np.testing.assert_array_equal(blk.nodes[:got.n_real],
                                  np.arange(want.n_real))


def test_reference_batches_break_the_label_range():
    """The reason for the port's draw: the reference's ``_random_like``
    draws every int32 field in [0, min(size, 50)), so gatedgcn's labels
    pass its ``n_classes`` (and the smoke loss turns NaN)."""
    jcell = jsteps.build_cell("gatedgcn", "full_graph_sm", smoke=True)
    jb = next(jtrain._data_for(jcell, smoke=True))
    assert int(jnp.max(jb.labels)) >= jcell.config.n_classes
    assert not np.isfinite(float(jax.jit(jcell.step)(
        jcell.init_params(jax.random.PRNGKey(0)),
        jcell.init_opt(jcell.init_params(jax.random.PRNGKey(0))), 0,
        jb)[2]["loss"]))


@pytest.mark.parametrize("arch,n_layers", [("gatedgcn", None), ("mace", None),
                                           ("equiformer-v2", 11)])
def test_snapshot_files_equal_the_reference_files(tmp_path, arch, n_layers):
    """``(params, adamw state)`` saved by both packages: the same file
    names and bytes, manifest included (equiformer-v2 at 11 layers: the
    layer list keeps its order past 10)."""
    mod = registry.get_module(arch)
    cfg = mod.smoke_config()
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    jmod = jsteps._GNN_MODELS[arch]
    jcfg = dataclasses.replace(jsteps.registry.get_module(arch)
                               .smoke_config(), n_layers=cfg.n_layers)
    jp = jmod.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    params = steps._GNN_MODELS[arch].params_from_numpy(tree, cfg, "cpu")
    from repro.optim import adamw as jadamw
    from repro_torch.optim import adamw

    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    JManager(str(jdir)).save(0, (jp, jadamw().init(jp)), wait=True)
    CheckpointManager(str(tdir)).save(
        0, (params, adamw().init(params.tree())), wait=True)
    names = sorted(os.listdir(jdir / "step_0"))
    assert names == sorted(os.listdir(tdir / "step_0"))
    for name in names:
        assert (jdir / "step_0" / name).read_bytes() == \
            (tdir / "step_0" / name).read_bytes(), name
    other = steps._GNN_MODELS[arch].init_params(cfg, seed=1, device="cpu")
    (back, _), _ = CheckpointManager(str(tdir)).restore(
        (other, adamw().init(other.tree())), device="cpu")
    for a, b in zip(jax.tree_util.tree_leaves(back.tree()),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a.detach().numpy(), b)


def test_train_cli_trains_a_gnn(tmp_path, capsys):
    args = ["--arch", "equiformer-v2", "--smoke", "--device", "cpu",
            "--shape", "molecule", "--ckpt-dir", str(tmp_path)]
    _, _, last = train.main(args + ["--steps", "2"])
    _, _, last = train.main(args + ["--steps", "3"])    # resumes at 2
    assert last == 2
    out = capsys.readouterr().out
    assert [ln.split(":")[0] for ln in out.splitlines()] == [
        f"step {i}" for i in range(3)]


def test_train_module_entry_point_gatedgcn(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "gatedgcn", "--smoke", "--device", "cpu", "--steps", "3",
         "--ckpt-dir", str(tmp_path)], capture_output=True, text=True,
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"),
                       "PATH": "/usr/bin:/bin"}, timeout=120)
    assert proc.returncode == 0, proc.stderr
    losses = [float(ln.split("loss=")[1].split()[0])
              for ln in proc.stdout.splitlines()]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert (tmp_path / "gatedgcn" / "step_2" / "manifest.json").exists()
