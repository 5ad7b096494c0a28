"""Rhizomes — skew-aware hub splitting (a numpy copy of
``repro.core.rhizome``: the port imports nothing of the JAX package, and
both packages must route every edge of a split hub to the same member).

Power-law graphs concentrate a hub's edges into the one compute cell that
owns the vertex, so that cell's blocked-CSR stream (and with it the whole
sweep, which is sized by the max cell load) scales with the skew tail
instead of the mean.  Following the Rhizomes companion paper
(arxiv 2402.06086), a vertex whose live degree exceeds
``replica_threshold`` is split into R *member* slots spread over distinct
cells: member 0 is the primary (the slot the NameServer resolves), members
1..R-1 are replicas.  The hub's out-edges are stored across members and
its in-edges are retargeted across members, both by the deterministic
:func:`member_rank` hash — so a later ``edge_delete(u, v)`` probes exactly
the cell the build (or an earlier ``edge_add``) used, keeping
incremental == rebuild bitwise.

All members mirror the same vertex state: the engines suppress local
inbox delivery at member slots and merge member partials through the
program's monoid once per round at the exchange, re-broadcasting the
merged value to every member (core/diffuse.py).  This module holds only
the pure split policy: the hash, the threshold rule, and the member-count
rule — shared by partition, the update pipeline, and the benchmarks.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "member_rank",
    "resolve_replica_threshold",
    "replica_counts",
]

_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)

# Auto threshold = max cell load targeted at this fraction of the mean
# per-cell live-edge load (an eighth), floored at one CSR block — below a
# block the split can't shorten any run.
AUTO_THRESHOLD_DIVISOR = 8


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer (vectorized uint64); wraps mod 2^64."""
    x = np.asarray(x, np.uint64)
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint64(30))) * _M1
        x = (x ^ (x >> np.uint64(27))) * _M2
        return x ^ (x >> np.uint64(31))


def member_rank(hub_gid, other_gid, n_members):
    """Deterministic member index in [0, n_members) for an edge touching a
    split hub, keyed on the (hub, other endpoint) pair.

    Used for both roles of an edge: the *storage* member of a split
    source u is ``member_rank(u, v, R_u)`` and the *target* member of a
    split destination v is ``member_rank(v, u, R_v)``.  ``n_members`` may
    be an array (per-hub R); entries of 1 always map to member 0, so
    unsplit endpoints can go through the same call.
    """
    h = np.asarray(hub_gid, np.uint64)
    o = np.asarray(other_gid, np.uint64)
    with np.errstate(over="ignore"):
        key = _mix64((h << np.uint64(32)) ^ o)
    r = np.asarray(n_members, np.uint64)
    return (key % np.maximum(r, np.uint64(1))).astype(np.int32)


def resolve_replica_threshold(replica_threshold, n_live_edges: int,
                              n_shards: int, block: int) -> int | None:
    """Normalize the user-facing knob to a concrete degree threshold.

    ``None`` disables splitting; ``"auto"`` targets an eighth of the mean
    per-cell live-edge load (min one CSR block); an int passes through
    (min 1 so R = ceil(deg/thr) stays finite).
    """
    if replica_threshold is None:
        return None
    if replica_threshold == "auto":
        mean_cell_load = n_live_edges // max(n_shards, 1)
        return max(block, mean_cell_load // AUTO_THRESHOLD_DIVISOR)
    thr = int(replica_threshold)
    if thr < 1:
        raise ValueError(f"replica_threshold must be >= 1 or 'auto', "
                         f"got {replica_threshold!r}")
    return thr


def replica_counts(total_degree: np.ndarray, threshold: int,
                   n_shards: int) -> np.ndarray:
    """Members per vertex: 1 (unsplit) below the threshold, else
    ceil(degree / threshold) capped at one member per cell."""
    deg = np.asarray(total_degree, np.int64)
    r = -(-deg // max(threshold, 1))
    r = np.where(deg > threshold, r, 1)
    return np.minimum(np.maximum(r, 1), n_shards).astype(np.int32)
