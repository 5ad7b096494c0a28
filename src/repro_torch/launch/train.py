"""Training launcher: ``python -m repro_torch.launch.train --arch <id> ...``

The port of ``repro/launch/train.py``: a cell (config x shape), the data
pipeline and the fault-tolerant trainer wired together.  ``--smoke
--device cpu`` runs the smoke config on the CPU; on one H100 the full
config of tinyllama-1.1b trains with the global batch cut to fit, and the
GNNs and two-tower retrieval at their cells' full widths:

    python -m repro_torch.launch.train --arch tinyllama-1.1b --batch 8
    python -m repro_torch.launch.train --arch gatedgcn --shape minibatch_lg
    python -m repro_torch.launch.train --arch two-tower-retrieval

The LM family reads the ``TokenPipeline`` synthetic stream (no corpus is
in the repository) through a ``Prefetcher``, and each batch moves to the
device on the caller thread.  A GNN trains on one fixed seeded batch fed
again every step, as in the reference (full-batch semantics), moved to
the device once.  Its graph is the shape's (``cell_structure``), padded
with masks, with every real node of a full or batched shape receiving an
edge inside the geometric models' cutoff, and its index fields are drawn
inside their ranges (the reference draws every int32 field in ``[0,
min(size, 50))``, so its labels pass ``n_classes`` and its species
``n_species``, and a node may receive nothing: ROADMAP queue 3).  Without
``--shape`` a GNN trains on its first shape (the reference's launcher
finds no ``"train"``-mode GNN shape and stops).  Two-tower retrieval
trains on train_batch by default, on the ``RecsysPipeline`` synthetic
clickstream (seed 0, as the reference), each batch moved to the device on
the caller thread.
"""

from __future__ import annotations

import argparse
import itertools
import os
import tempfile
from typing import NamedTuple

import numpy as np
import torch

from ..configs import registry
from ..data.pipeline import Prefetcher, RecsysPipeline, TokenPipeline
from ..models.gnn.common import GraphBatch, partition_edges_by_receiver
from ..models.sampler import SampledBlocks, block_shapes
from ..runtime.trainer import train_loop
from .steps import build_cell


# positions ``normal * 0.5``: an edge is longer than the geometric models'
# 5.0 cutoff with odds under 1e-10
POSITION_SCALE = 0.5
# a smoke cell's sampled block (64 nodes, 256 edges): 4 seeds, fanout (3, 2)
SMOKE_BLOCK = (4, (3, 2))


class GraphStructure(NamedTuple):
    """A batch's graph before padding: edges ``senders -> receivers`` among
    ``n_real`` nodes, and each node's graph (None: one graph)."""
    senders: np.ndarray
    receivers: np.ndarray
    n_real: int
    graph_ids: np.ndarray | None = None


def random_graphs(graphs: int, nodes: int, edges: int,
                  rng) -> GraphStructure:
    """``graphs`` graphs of ``nodes`` nodes and ``edges`` edges each, every
    edge inside its graph and no self-loop.  Node i of a graph receives
    edge i (each node receives one where ``edges >= nodes``), the other
    receivers and every sender are uniform.  A node that receives nothing
    keeps equiformer-v2's l >= 1 features at zero, whose RMS norm then
    multiplies their gradient by 1 / sqrt(1e-6) a block (ROADMAP queue
    3)."""
    rcv = rng.integers(0, nodes, (graphs, edges))
    first = min(nodes, edges)
    rcv[:, :first] = np.arange(first)
    snd = (rcv + rng.integers(1, nodes, rcv.shape)) % nodes
    base = np.arange(graphs)[:, None] * nodes
    return GraphStructure((base + snd).ravel(), (base + rcv).ravel(),
                          graphs * nodes, np.repeat(np.arange(graphs), nodes))


def tree_block(seeds: int, fanout) -> GraphStructure:
    """The block ``sampler.sample_blocks`` draws from a graph in which no
    node is reached twice: the seeds first, then each hop's nodes, every
    edge from a new node to the node that sampled it."""
    snd, rcv = [], []
    frontier, top = np.arange(seeds), seeds
    for f in fanout:
        kids = top + np.arange(len(frontier) * f)
        snd.append(kids)
        rcv.append(np.repeat(frontier, f))
        frontier, top = kids, top + len(kids)
    return GraphStructure(np.concatenate(snd), np.concatenate(rcv), top)


def block_structure(blk: SampledBlocks) -> GraphStructure:
    """A ``sample_blocks`` block's real edges and nodes."""
    return GraphStructure(blk.senders[blk.edge_mask],
                          blk.receivers[blk.edge_mask],
                          int(blk.node_mask.sum()))


def cell_structure(cell, rng) -> GraphStructure:
    """The graph of a cell's seeded batch: for a full-graph shape one graph
    of the shape's nodes and edges, for a batched shape its molecules
    (``random_graphs``), for a sampled shape the tree of its seeds and
    fanout (``tree_block``); smoke cells cut each to their 64 nodes and
    256 edges."""
    shape = registry.shapes_for(cell.arch_id)[cell.shape_name]
    specs = cell.input_specs()
    n, e = specs.n_nodes, specs.senders.shape[0]
    if shape.mode == "sampled":
        seeds, fanout = shape.batch_nodes, shape.fanout
        nb, eb = block_shapes(seeds, fanout)
        if nb > n or eb > e:
            seeds, fanout = SMOKE_BLOCK
        return tree_block(seeds, fanout)
    g = specs.n_graphs
    return random_graphs(g, min(shape.n_nodes, n // g),
                         min(shape.n_edges, e // g), rng)


def gnn_batch(cell, seed: int = 0,
              structure: GraphStructure | None = None,
              data_shards: int = 1) -> GraphBatch:
    """One seeded host batch (numpy) of a GNN cell's input specs on
    ``structure`` (default: ``cell_structure``), padded to the specs' sizes
    with masks over its real nodes and edges; positions ``normal *
    POSITION_SCALE``, other float fields ``normal * 0.1``, species and
    class labels inside their ranges.  For a ``spmd_edges`` cell on a mesh
    of ``data_shards`` > 1 data shards the edges are laid out by receiver
    block (``partition_edges_by_receiver``, each block's share a multiple
    of ``edge_chunks``): the edge count then differs from the spec's."""
    specs, cfg = cell.input_specs(), cell.config
    rng = np.random.default_rng(seed)
    st = structure or cell_structure(cell, rng)
    n, e = specs.n_nodes, specs.senders.shape[0]
    e_real = len(st.senders)
    if st.n_real > n or e_real > e:
        raise ValueError(f"a graph of {st.n_real} nodes and {e_real} edges "
                         f"does not fit the cell's {n} and {e}")

    def pad(a, size):
        full = np.zeros(size, np.int32)
        full[:len(a)] = a
        return full

    fixed = {"senders": pad(st.senders, e), "receivers": pad(st.receivers, e),
             "node_mask": np.arange(n) < st.n_real,
             "edge_mask": np.arange(e) < e_real,
             "graph_ids": pad(st.graph_ids if st.graph_ids is not None
                              else [], n)}
    bounds = {"species": getattr(cfg, "n_species", None),
              "labels": getattr(cfg, "n_classes", None) or
              getattr(cfg, "d_out", None)}

    def draw(name, spec):
        if name in fixed:
            return fixed[name]
        if spec.dtype == torch.int32:
            return rng.integers(0, bounds[name], size=spec.shape,
                                dtype=np.int32)
        scale = POSITION_SCALE if name == "positions" else 0.1
        return (rng.normal(size=spec.shape) * scale).astype(np.float32)

    batch = GraphBatch(n_nodes=n, n_graphs=specs.n_graphs,
                       **{k: draw(k, v) for k, v in specs.fields().items()})
    if getattr(cfg, "spmd_edges", False) and data_shards > 1:
        batch = partition_edges_by_receiver(
            batch, data_shards, max(getattr(cfg, "edge_chunks", 1), 1))
    return batch


def data_for(cell):
    """The cell's batch stream on the host (numpy): the LM family's
    synthetic tokens, a GNN's one fixed batch again and again, the recsys
    synthetic clickstream."""
    if cell.family.startswith("gnn"):
        return itertools.repeat(gnn_batch(cell))
    if cell.family == "recsys":
        return RecsysPipeline(cell.input_specs()["item_ids"].shape[0],
                              cell.config)
    b, s = cell.input_specs()["tokens"].shape
    return TokenPipeline(b, s, cell.config.vocab)


def _to_device(batch, device):
    def put(v):
        return torch.from_numpy(v).to(device)
    if isinstance(batch, GraphBatch):
        return batch.map(put)
    return {k: put(v) for k, v in batch.items()}


def on_device(batches, device):
    """Each host batch (a dict or a ``GraphBatch`` of numpy arrays) as
    tensors on ``device``; a batch that comes again (a GNN's fixed batch)
    is moved once and handed out again."""
    last, moved = None, None
    for batch in batches:
        if batch is not last:
            last, moved = batch, _to_device(batch, device)
        yield moved


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default=None,
                    help="a training shape (default: the arch's first)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--batch", type=int, default=None,
                    help="cut an LM or recsys shape's global batch "
                         "(train_4k: 256, train_batch: 65536)")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25,
                    help="steps between snapshots (0: none)")
    ap.add_argument("--log", default=None)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    shapes = registry.shapes_for(args.arch)
    shape = args.shape or next(s for s in shapes
                               if shapes[s].mode not in ("prefill",
                                                         "decode"))
    cell = build_cell(args.arch, shape, smoke=args.smoke, batch=args.batch,
                      device=args.device)
    if cell.mode != "train":
        raise SystemExit(f"shape {shape} is not a training shape")

    params = cell.init_params(0)
    opt_state = cell.init_opt(params)
    data = on_device(Prefetcher(data_for(cell)), args.device)

    def on_metrics(step, metrics, dt):
        print(f"step {step}: loss={float(metrics['loss']):.4f} "
              f"gnorm={float(metrics['grad_norm']):.3f} {dt*1e3:.0f}ms",
              flush=True)

    return train_loop(
        cell.step, params, opt_state, data, args.steps,
        ckpt_dir=os.path.join(args.ckpt_dir, args.arch),
        ckpt_every=args.ckpt_every, log_path=args.log,
        on_metrics=on_metrics,
    )


if __name__ == "__main__":
    main()
