"""Uniform-fanout neighbor sampler (GraphSAGE-style) for minibatch GNN
training at reddit/ogbn scale — a real sampler over CSR, host-side numpy
(the data-pipeline boundary), emitting fixed-shape padded blocks so every
step sees the same shapes.

The port's own copy of ``repro/models/sampler.py`` (numpy only): the same
arrays, bit for bit, for the same ``rng``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["CSRGraph", "SampledBlocks", "build_csr", "sample_blocks",
           "block_shapes"]


class CSRGraph(NamedTuple):
    indptr: np.ndarray    # [N+1]
    indices: np.ndarray   # [E]
    n_nodes: int


class SampledBlocks(NamedTuple):
    """K-hop sampled subgraph, fixed shapes (padded).

    nodes   [n_max]   — unique node ids, layer-0 seeds first (-1 pad)
    senders [e_max]   — indices INTO nodes (-1 pad)
    receivers [e_max]
    edge_mask [e_max]
    node_mask [n_max]
    seeds   [n_seeds]
    """
    nodes: np.ndarray
    senders: np.ndarray
    receivers: np.ndarray
    edge_mask: np.ndarray
    node_mask: np.ndarray
    seeds: np.ndarray


def build_csr(src: np.ndarray, dst: np.ndarray, n_nodes: int) -> CSRGraph:
    order = np.argsort(src, kind="stable")
    s, d = src[order], dst[order]
    indptr = np.searchsorted(s, np.arange(n_nodes + 1))
    return CSRGraph(indptr.astype(np.int64), d.astype(np.int32), n_nodes)


def block_shapes(batch_nodes: int, fanouts) -> tuple[int, int]:
    """(n_max, e_max) for given seeds + fanouts (the static shape contract)."""
    n_max = batch_nodes
    e_max = 0
    frontier = batch_nodes
    for f in fanouts:
        e_max += frontier * f
        frontier = frontier * f
        n_max += frontier
    return n_max, e_max


def sample_blocks(g: CSRGraph, seeds: np.ndarray, fanouts,
                  rng: np.random.Generator) -> SampledBlocks:
    seeds = np.asarray(seeds, np.int64)
    n_max, e_max = block_shapes(len(seeds), fanouts)
    id_of = {}
    nodes = []

    def intern(v: int) -> int:
        k = id_of.get(v)
        if k is None:
            k = len(nodes)
            id_of[v] = k
            nodes.append(v)
        return k

    for s in seeds:
        intern(int(s))
    snd, rcv = [], []
    frontier = list(seeds)
    for f in fanouts:
        nxt = []
        for v in frontier:
            lo, hi = g.indptr[v], g.indptr[v + 1]
            deg = hi - lo
            if deg == 0:
                continue
            take = min(f, deg) if deg <= f else f
            picks = (
                g.indices[lo:hi]
                if deg <= f
                else g.indices[lo + rng.integers(0, deg, size=f)]
            )
            for u in picks[:take]:
                ui = intern(int(u))
                snd.append(ui)
                rcv.append(id_of[int(v)])
                nxt.append(int(u))
        frontier = nxt

    n, e = len(nodes), len(snd)
    nodes_a = np.full(n_max, -1, np.int64)
    nodes_a[:n] = nodes
    snd_a = np.zeros(e_max, np.int32)
    rcv_a = np.zeros(e_max, np.int32)
    snd_a[:e] = snd
    rcv_a[:e] = rcv
    emask = np.zeros(e_max, bool)
    emask[:e] = True
    nmask = np.zeros(n_max, bool)
    nmask[:n] = True
    return SampledBlocks(nodes_a, snd_a, rcv_a, emask, nmask, seeds)
