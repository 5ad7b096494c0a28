"""The assigned input-shape cells (40 total across 10 architectures).

The port's own copy of ``repro/configs/shapes.py`` (no framework import).

Each family has its own shape set; ``long_500k`` is skipped for the five
pure-full-attention LM archs per the assignment (noted in DESIGN.md §5).
"""

from __future__ import annotations

import dataclasses

__all__ = ["LMShape", "GraphShape", "RecsysShape", "LM_SHAPES", "GNN_SHAPES",
           "RECSYS_SHAPES", "SKIPPED_CELLS"]


@dataclasses.dataclass(frozen=True)
class LMShape:
    name: str
    mode: str          # train | prefill | decode
    seq_len: int
    global_batch: int
    needs_subquadratic: bool = False


@dataclasses.dataclass(frozen=True)
class GraphShape:
    name: str
    mode: str          # full | sampled | batched
    n_nodes: int
    n_edges: int
    d_feat: int = 0
    n_classes: int = 0
    batch_nodes: int = 0          # sampled mode
    fanout: tuple = ()
    batch_graphs: int = 1         # batched-small-graphs mode
    edge_chunks: int = 1          # memory plan for the big cells


@dataclasses.dataclass(frozen=True)
class RecsysShape:
    name: str
    mode: str          # train | serve | retrieval
    batch: int
    n_candidates: int = 0


LM_SHAPES = {
    "train_4k": LMShape("train_4k", "train", 4_096, 256),
    "prefill_32k": LMShape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": LMShape("decode_32k", "decode", 32_768, 128),
    "long_500k": LMShape("long_500k", "decode", 524_288, 1,
                         needs_subquadratic=True),
}

GNN_SHAPES = {
    "full_graph_sm": GraphShape(
        "full_graph_sm", "full", 2_708, 10_556, d_feat=1_433, n_classes=7
    ),
    "minibatch_lg": GraphShape(
        "minibatch_lg", "sampled", 232_965, 114_615_892, d_feat=602,
        n_classes=41, batch_nodes=1_024, fanout=(15, 10),
    ),
    "ogb_products": GraphShape(
        "ogb_products", "full", 2_449_029, 61_859_140, d_feat=100,
        n_classes=47, edge_chunks=64,
    ),
    "molecule": GraphShape(
        "molecule", "batched", 30, 64, batch_graphs=128,
    ),
}

RECSYS_SHAPES = {
    "train_batch": RecsysShape("train_batch", "train", 65_536),
    "serve_p99": RecsysShape("serve_p99", "serve", 512),
    "serve_bulk": RecsysShape("serve_bulk", "serve", 262_144),
    "retrieval_cand": RecsysShape("retrieval_cand", "retrieval", 1,
                                  n_candidates=1_000_000),
}

# (arch, shape) cells not run, with the reason recorded for EXPERIMENTS.md
SKIPPED_CELLS = {
    (arch, "long_500k"): (
        "long_500k requires sub-quadratic attention; this arch is pure "
        "full (GQA) attention — skipped per assignment rule"
    )
    for arch in [
        "command-r-plus-104b", "tinyllama-1.1b", "qwen2-7b",
        "grok-1-314b", "phi3.5-moe-42b-a6.6b",
    ]
}
