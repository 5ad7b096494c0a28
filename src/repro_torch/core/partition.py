"""Vertex partitioners: map a Graph onto S compute cells (PyTorch port of
``repro.core.partition``, without hub replicas).

The paper's "logical locality" says graph topology, not address adjacency,
is the locality that matters.  ``locality`` approximates it with a BFS
traversal order; ``hash`` is the adversarial baseline; ``block`` keeps the
generator's vertex order.

The build runs on the host in numpy exactly as the JAX package's does —
the same cut, the same one sort by ``(owner, dst_key)`` that makes slot
order the destination-sorted stream, and the same host-assembled views —
so both packages produce identical arrays; only the final upload differs.
"""

from __future__ import annotations

import numpy as np
import torch

from .graph import (
    DEFAULT_EDGE_BLOCK,
    Graph,
    ShardedGraph,
    default_delta_blocks,
)

__all__ = ["partition", "Partitioned"]

# Above this vertex count ``strategy="locality"`` falls back to ``block``.
LOCALITY_FALLBACK_NODES = 1 << 20

# Equal-vertex chunking is kept until its max-cell edge count exceeds this
# multiple of the mean; past that the cut switches to the degree-aware
# budget.
CAPACITY_SKEW_THRESHOLD = 1.75


class Partitioned:
    """ShardedGraph plus the global <-> (cell, slot) maps."""

    def __init__(self, sg: ShardedGraph, owner, local,
                 n_real: int | None = None):
        self.sg = sg
        owner = np.array(owner, np.int32)     # own, writable copies
        local = np.array(local, np.int32)
        self.owner_np, self.local_np = owner, local     # host copies
        self.owner = torch.from_numpy(owner).to(sg.device)   # [n_nodes]
        self.local = torch.from_numpy(local).to(sg.device)   # [n_nodes]
        self.n_real = int(n_real) if n_real is not None else int(owner.shape[0])

    @classmethod
    def from_numpy(cls, arrays: dict, meta: dict, owner, local,
                   n_real: int | None = None, device="cuda") -> "Partitioned":
        """Load a partition built elsewhere — the JAX package's
        ``sg.state_dict()`` / ``sg.meta_dict()`` and ``owner``/``local`` as
        numpy arrays — onto ``device``."""
        sg = ShardedGraph.from_state(arrays, meta, device=device)
        return cls(sg, owner, local, n_real=n_real)

    def to_shard_layout(self, values, fill):
        """[n_nodes] global tensor -> [S, Np] shard layout."""
        values = torch.as_tensor(values, device=self.sg.device)
        out = torch.full((self.sg.n_shards, self.sg.n_per_shard), fill,
                         dtype=values.dtype, device=values.device)
        out[self.owner.long(), self.local.long()] = values
        return out

    def to_global_layout(self, values):
        """[S, Np] shard layout -> [n_nodes] global tensor."""
        return values[self.owner.long(), self.local.long()]


def _bfs_order(src: np.ndarray, dst: np.ndarray, n: int) -> np.ndarray:
    """BFS traversal order over all components (host side, vectorized,
    level-synchronous with first-occurrence dedup in discovery order)."""
    order = np.argsort(src, kind="stable")
    s_sorted, d_sorted = src[order], dst[order]
    starts = np.searchsorted(s_sorted, np.arange(n))
    ends = np.searchsorted(s_sorted, np.arange(n) + 1)
    visited = np.zeros(n, bool)
    out = np.empty(n, np.int64)
    k = 0
    root = 0
    while k < n:
        while root < n and visited[root]:
            root += 1
        visited[root] = True
        frontier = np.array([root], np.int64)
        while frontier.size:
            out[k:k + frontier.size] = frontier
            k += frontier.size
            cnt = ends[frontier] - starts[frontier]
            total = int(cnt.sum())
            if not total:
                break
            offs = np.cumsum(cnt) - cnt
            idx = np.repeat(starts[frontier] - offs, cnt) + np.arange(total)
            nbrs = d_sorted[idx]
            nbrs = nbrs[~visited[nbrs]]
            _, first = np.unique(nbrs, return_index=True)
            nbrs = nbrs[np.sort(first)]
            visited[nbrs] = True
            frontier = nbrs
    return out


def _degree_aware_cut(live_deg_sorted: np.ndarray, n_shards: int):
    """Cut an ordered vertex sequence into ``n_shards`` contiguous chunks
    balanced by cost = out_degree + mean degree.  Returns the per-rank
    cell id."""
    n_live = live_deg_sorted.shape[0]
    if n_live == 0:
        return np.empty(0, np.int64)
    t = max(1, int(live_deg_sorted.sum()) // n_live)
    cost = live_deg_sorted.astype(np.int64) + t
    prefix = np.cumsum(cost) - cost
    budget = -(-int(cost.sum()) // n_shards)
    return np.minimum(prefix // budget, n_shards - 1)


def partition(graph: Graph, n_shards: int, strategy: str = "block",
              seed: int = 0, replica_threshold=None) -> Partitioned:
    """Partition ``graph`` over ``n_shards`` compute cells, on the graph's
    device.

    strategy: 'block' | 'hash' | 'locality'.  ``replica_threshold`` (hub
    splitting) belongs to the replicas slice and must be None.
    """
    if replica_threshold is not None:
        raise NotImplementedError(
            "replica_threshold (rhizome hub splitting) is not ported yet: "
            "it arrives with the replicas slice")
    device = graph.src.device
    n = graph.n_nodes
    src = graph.src.cpu().numpy()
    dst = graph.dst.cpu().numpy()
    w = graph.weight.cpu().numpy()
    eok = graph.edge_ok.cpu().numpy()
    nok = graph.node_ok.cpu().numpy()

    live = np.where(nok)[0]
    n_live = live.shape[0]
    if strategy == "locality" and n > LOCALITY_FALLBACK_NODES:
        strategy = "block"
    if strategy == "block":
        live_sorted = live
    elif strategy == "hash":
        rng = np.random.default_rng(seed)
        live_sorted = live[rng.permutation(n_live)]
    elif strategy == "locality":
        order = _bfs_order(src[eok], dst[eok], n)
        pos = np.empty(n, np.int64)
        pos[order] = np.arange(n)
        live_sorted = live[np.argsort(pos[live], kind="stable")]
    else:
        raise ValueError(f"unknown strategy {strategy!r}")

    live_deg = np.bincount(src[eok], minlength=n)
    deg_ranked = live_deg[live_sorted]
    q = max(1, -(-n_live // n_shards))
    eq_cells = np.minimum(np.arange(n_live) // q, n_shards - 1)
    eq_load = np.bincount(eq_cells, weights=deg_ranked, minlength=n_shards)
    mean_load = max(1.0, float(deg_ranked.sum()) / n_shards)
    if eq_load.max(initial=0.0) > CAPACITY_SKEW_THRESHOLD * mean_load:
        cell_of_rank = _degree_aware_cut(deg_ranked, n_shards)
    else:
        cell_of_rank = eq_cells
    cell_counts = np.bincount(cell_of_rank, minlength=n_shards)
    starts = np.concatenate([[0], np.cumsum(cell_counts)])[:-1]
    owner = np.zeros(n, np.int32)
    local = np.zeros(n, np.int32)
    r = np.arange(n_live)
    owner[live_sorted] = cell_of_rank.astype(np.int32)
    local[live_sorted] = (r - starts[cell_of_rank]).astype(np.int32)

    n_per = max(int(cell_counts.max(initial=0)), -(-n // n_shards))
    # free (dead) slots fill the remaining (cell, slot) positions in
    # row-major order
    dead = np.where(~nok)[0]
    if dead.size:
        free_per_cell = n_per - cell_counts
        cumfree = np.cumsum(free_per_cell)
        k = np.arange(dead.size)
        cell = np.searchsorted(cumfree, k, side="right")
        within = k - (cumfree[cell] - free_per_cell[cell])
        owner[dead] = cell.astype(np.int32)
        local[dead] = (cell_counts[cell] + within).astype(np.int32)

    # Live edges, sorted ONCE by (owner cell, destination key): contiguous
    # runs per cell, already in pull-CSR order — slot order IS stream order.
    # The same (unstable) numpy sort as the JAX package, so ties between
    # parallel edges land in the same slots in both.
    e_idx = np.where(eok)[0]
    e_src, e_dst, e_w = src[e_idx], dst[e_idx], w[e_idx]
    e_owner, e_sl = owner[e_src], local[e_src]
    e_do, e_dl = owner[e_dst], local[e_dst]
    e_key = e_do.astype(np.int64) * n_per + e_dl
    order = np.argsort(e_owner * (np.int64(n_shards) * n_per) + e_key)
    e_dst, e_w = e_dst[order], e_w[order]
    e_owner, e_key = e_owner[order], e_key[order]
    e_sl, e_do, e_dl = e_sl[order], e_do[order], e_dl[order]
    counts = np.bincount(e_owner, minlength=n_shards)

    slack_total = int(eok.shape[0] - eok.sum())
    block = DEFAULT_EDGE_BLOCK
    epc = max(1, int(counts.max(initial=0)) + -(-slack_total // n_shards))
    ep = -(-epc // block) * block    # sorted_width == ep: no view re-pad

    S = n_shards
    src_local = np.zeros((S, ep), np.int32)
    dst_shard = np.zeros((S, ep), np.int32)
    dst_local = np.zeros((S, ep), np.int32)
    dst_gid = np.zeros((S, ep), np.int32)
    weight = np.zeros((S, ep), np.float32)
    edge_ok = np.zeros((S, ep), bool)
    e_offsets = np.concatenate([[0], np.cumsum(counts)])
    for s in range(S):
        lo, hi = e_offsets[s], e_offsets[s + 1]
        k = hi - lo
        src_local[s, :k] = e_sl[lo:hi]
        dst_shard[s, :k] = e_do[lo:hi]
        dst_local[s, :k] = e_dl[lo:hi]
        dst_gid[s, :k] = e_dst[lo:hi]
        weight[s, :k] = e_w[lo:hi]
        edge_ok[s, :k] = True

    node_ok = np.zeros((S, n_per), bool)
    gid = np.zeros((S, n_per), np.int32)
    node_ok[owner, local] = nok[:n]
    gid[owner, local] = np.arange(n, dtype=np.int32)
    deg = np.zeros((S, n_per), np.int32)
    deg[owner, local] = live_deg[:n]

    # Both blocked-CSR views assembled host-side, identical to a full
    # with_csr() rebuild: the pull view's sorted region is the identity
    # permutation; the push view is one stable sort by source local index.
    delta_blocks = default_delta_blocks(ep, block)
    width = ep + delta_blocks * block
    csr_perm = np.zeros((S, width), np.int32)
    csr_perm[:, :ep] = np.arange(ep, dtype=np.int32)
    csr_key = np.full((S, width), -1, np.int32)
    ek32 = e_key.astype(np.int32)
    for s in range(S):
        lo, hi = e_offsets[s], e_offsets[s + 1]
        csr_key[s, : hi - lo] = ek32[lo:hi]
    csr_inv = np.broadcast_to(np.arange(ep, dtype=np.int32), (S, ep)).copy()

    pkey = np.where(edge_ok, src_local, n_per)
    # (src, slot) composite is collision-free, so the default sort equals a
    # stable argsort of pkey
    pcomp = pkey.astype(np.int64) * ep + np.arange(ep, dtype=np.int64)
    pperm = np.argsort(pcomp, axis=1).astype(np.int32)
    psrc = np.take_along_axis(pkey, pperm, axis=1).astype(np.int32)
    psrc[psrc >= n_per] = -1
    ppos = np.where(psrc >= 0, pperm, -1)     # dense position == slot here
    pinv = np.zeros((S, ep), np.int32)
    np.put_along_axis(pinv, pperm, np.broadcast_to(
        np.arange(ep, dtype=np.int32), (S, ep)), axis=1)
    push_perm = np.zeros((S, width), np.int32)
    push_perm[:, :ep] = pperm
    push_src = np.full((S, width), -1, np.int32)
    push_src[:, :ep] = psrc
    push_pos = np.full((S, width), -1, np.int32)
    push_pos[:, :ep] = ppos

    arrays = dict(
        src_local=src_local, dst_shard=dst_shard, dst_local=dst_local,
        dst_gid=dst_gid, weight=weight, edge_ok=edge_ok, node_ok=node_ok,
        gid=gid, out_degree=deg, csr_perm=csr_perm, csr_key=csr_key,
        csr_live=csr_key >= 0, csr_inv=csr_inv, push_perm=push_perm,
        push_src=push_src, push_pos=push_pos, push_inv=pinv,
        delta_count=np.zeros((S,), np.int32),
        tomb_count=np.zeros((S,), np.int32),
    )
    meta = dict(n_shards=S, n_per_shard=n_per, n_nodes=n, csr_block=block,
                delta_blocks=delta_blocks)
    return Partitioned.from_numpy(arrays, meta, owner, local,
                                  n_real=int(nok.sum()), device=device)
