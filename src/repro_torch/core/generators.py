"""Graph-family generators used by the paper's experiments (Table II).

A numpy copy of ``repro.core.generators`` (the port imports nothing of the
JAX package), so both packages build bit-identical edge lists from a seed.

Five families: Erdős–Rényi, Small-World (Watts–Strogatz), Scale-Free
(Barabási–Albert), Powerlaw-Clustered (Holme–Kim), and Graph500 (RMAT /
stochastic Kronecker).  All generators are host-side numpy (the data pipeline
boundary), seedable, and return symmetric (both directions) deduplicated edge
lists without self-loops, plus optional uniform random weights.

All generators are fully vectorized so graph500 s18-s20 class inputs
(hundreds of thousands to millions of vertices, tens of millions of directed
edges) build in seconds; edge streams are int32 end-to-end.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "erdos_renyi",
    "small_world",
    "scale_free",
    "powerlaw_cluster",
    "graph500_rmat",
    "GENERATORS",
    "make_graph_family",
]


def _symmetrize_dedup(src: np.ndarray, dst: np.ndarray, n: int):
    """Drop self loops, symmetrize, deduplicate. Returns (src, dst).

    Works on packed int64 keys only (one unique, no index array), so the peak
    footprint is ~2 int64 arrays of the directed edge count; output is int32.
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    key = np.concatenate([src * n + dst, dst * n + src])
    del src, dst
    key = np.unique(key)  # sorted + deduplicated
    return (key // n).astype(np.int32), (key % n).astype(np.int32)


def erdos_renyi(n: int, avg_degree: float = 8.0, seed: int = 0):
    """G(n, m) with m = n * avg_degree / 2 undirected edges."""
    rng = np.random.default_rng(seed)
    m = int(n * avg_degree / 2)
    src = rng.integers(0, n, size=2 * m)  # oversample; dedup trims
    dst = rng.integers(0, n, size=2 * m)
    return _symmetrize_dedup(src, dst, n)


def small_world(n: int, k: int = 8, beta: float = 0.1, seed: int = 0):
    """Watts–Strogatz: ring lattice with k neighbors, rewire prob beta."""
    rng = np.random.default_rng(seed)
    base = np.arange(n, dtype=np.int64)
    srcs, dsts = [], []
    for j in range(1, k // 2 + 1):
        s = base
        d = (base + j) % n
        rewire = rng.random(n) < beta
        d = np.where(rewire, rng.integers(0, n, size=n), d)
        srcs.append(s)
        dsts.append(d)
    return _symmetrize_dedup(np.concatenate(srcs), np.concatenate(dsts), n)


def _resolve_repeated(ref: np.ndarray, m: int) -> np.ndarray:
    """Resolve preferential-attachment picks against the virtual repeated
    array of the Batagelj–Brandes construction.

    The repeated-nodes array ``A`` is never materialized: ``A[:m]`` are the
    seed vertices ``0..m-1``, and thereafter edge ``k`` (``k = 0..E-1``)
    appends its source at position ``m + 2k`` and its target at ``m + 2k+1``.
    ``ref[k]`` is a uniform pick from ``[0, m + 2k)``; an odd-offset pick
    lands on an earlier target slot, i.e. on ``ref`` of an earlier edge, so
    picks form chains that always terminate at a seed vertex or a source
    slot.  Chain length halves the index each hop, so the loop runs
    O(log E) iterations over the full array.
    """
    t = ref.copy()
    while True:
        odd = (t >= m) & ((t - m) & 1 == 1)
        if not odd.any():
            break
        t[odd] = ref[(t[odd] - m) >> 1]
    return t


def scale_free(n: int, m: int = 4, seed: int = 0):
    """Barabási–Albert preferential attachment, fully vectorized.

    Uses the Batagelj–Brandes repeated-nodes construction: sampling a
    uniform position in the (virtual) array of all edge endpoints is
    degree-proportional sampling.  One batched RNG draw + O(log E) pointer
    resolution replaces the former per-vertex Python loop.
    """
    rng = np.random.default_rng(seed)
    if n <= m:
        e = np.empty(0, np.int64)
        return _symmetrize_dedup(e, e, max(n, 1))
    edges = (n - m) * m
    k = np.arange(edges, dtype=np.int64)
    src = m + k // m
    ref = rng.integers(0, m + 2 * k)
    t = _resolve_repeated(ref, m)
    # decode a repeated-array position into a vertex id: seeds are
    # themselves; even offsets are edge sources (m + k//m for edge k)
    dst = np.where(t < m, t, m + ((t - m) >> 1) // m)
    return _symmetrize_dedup(src, dst, n)


def powerlaw_cluster(n: int, m: int = 4, p: float = 0.5, seed: int = 0):
    """Holme–Kim: BA growth where each step closes a triangle w.p. ``p``.

    Vectorized over vertices: for each vertex's edge slot j > 0, with
    probability ``p`` the pick is redirected to the *partner endpoint* of the
    previous slot's edge (the neighbor-of-previous-target triad step); the
    partner of repeated-array position ``x >= m`` is ``m + ((x - m) ^ 1)``.
    Self-loops/duplicates this shortcut may create are removed by the final
    dedup pass, matching the generator's contract.
    """
    rng = np.random.default_rng(seed)
    if n <= m:
        e = np.empty(0, np.int64)
        return _symmetrize_dedup(e, e, max(n, 1))
    edges = (n - m) * m
    k = np.arange(edges, dtype=np.int64)
    src = m + k // m
    ref = rng.integers(0, m + 2 * k).reshape(n - m, m)
    triad = (rng.random(edges) < p).reshape(n - m, m)
    for j in range(1, m):  # m is tiny (default 4); rows stay vectorized
        prev = ref[:, j - 1]
        has_partner = prev >= m
        partner = np.where(has_partner, m + ((prev - m) ^ 1), prev)
        ref[:, j] = np.where(triad[:, j] & has_partner, partner, ref[:, j])
    t = _resolve_repeated(ref.reshape(-1), m)
    dst = np.where(t < m, t, m + ((t - m) >> 1) // m)
    return _symmetrize_dedup(src, dst, n)


def graph500_rmat(
    scale: int,
    edge_factor: int = 16,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
):
    """Graph500 RMAT (stochastic Kronecker) generator, vectorized."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * edge_factor
    dt = np.int32 if scale < 31 else np.int64
    src = np.zeros(m, dt)
    dst = np.zeros(m, dt)
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    for i in range(scale):
        r1 = rng.random(m)
        r2 = rng.random(m)
        src_bit = r1 > ab
        dst_bit = np.where(src_bit, r2 > c_norm, r2 > a_norm)
        src |= src_bit.astype(dt) << dt(i)
        dst |= dst_bit.astype(dt) << dt(i)
    # graph500 permutes vertex labels to break locality
    perm = rng.permutation(n).astype(dt)
    return _symmetrize_dedup(perm[src], perm[dst], n)


GENERATORS = {
    "erdos_renyi": erdos_renyi,
    "small_world": small_world,
    "scale_free": scale_free,
    "powerlaw_cluster": powerlaw_cluster,
    "graph500": graph500_rmat,
}


def make_graph_family(name: str, n: int, seed: int = 0, weighted: bool = True):
    """Build one of the paper's five graph families at ~n vertices.

    Returns (src, dst, weight, n). ``n`` in the result is the *actual*
    vertex-id space of the returned edges — for graph500 it is the next
    power of two >= the request (never smaller), and callers must size
    labels/weights off the returned value. Weights are uniform [1, 8) as is
    customary for weighted SSSP benchmarks (Graph500 SSSP uses uniform
    weights).
    """
    if name == "erdos_renyi":
        src, dst = erdos_renyi(n, avg_degree=8, seed=seed)
    elif name == "small_world":
        src, dst = small_world(n, k=8, beta=0.1, seed=seed)
    elif name == "scale_free":
        src, dst = scale_free(n, m=4, seed=seed)
    elif name == "powerlaw_cluster":
        src, dst = powerlaw_cluster(n, m=4, p=0.5, seed=seed)
    elif name == "graph500":
        scale = max(1, int(np.ceil(np.log2(max(2, n)))))
        src, dst = graph500_rmat(scale, seed=seed)
        n = 1 << scale
    else:  # pragma: no cover
        raise ValueError(f"unknown graph family {name!r}")
    rng = np.random.default_rng(seed + 1)
    w = (1.0 + 7.0 * rng.random(src.shape[0])).astype(np.float32) if weighted else None
    return src, dst, w, n
