"""The engine's gather -> emit -> segment-combine step (PyTorch port of
``repro.core.relax``, pull sweep only).

``make_relax`` builds the relaxation step of a program: every cell's
vertex block + destination-sorted edge stream -> the combined message
table per (cell, destination shard, destination slot).  The cells are a
leading batch dimension, so one kernel launch serves all of them.  Which
kernel runs — the hand-written CUDA one or its plain version — follows the
tensors' device.

The frontier-compacted ``push`` sweep and the per-sub-iteration ``auto``
selector arrive with the push kernel (K3) in a later slice.
"""

from __future__ import annotations

from typing import Callable

__all__ = ["RELAX_SWEEPS", "make_relax"]

# sweep directions of the JAX package; only "pull" is ported so far
RELAX_SWEEPS = ("pull", "push", "auto")


def make_relax(prog, n_shards: int, n_per_shard: int, block_e: int,
               delta_e: int = 0) -> Callable:
    """Build the pull-sweep relaxation step for ``prog``.

    The returned function maps (vstate dict of [S, Np] tensors, senders
    [S, Np] bool, the engine's stream dict ``sgd`` of [S, W] ``csr_*``
    tensors plus ``gid``) to

        table [S, S, Np]  combined messages per (cell, dst shard, dst slot)
        cnt   [S, S, Np]  int32 sending-edge count
        pay   [S, S, Np]  int32 argbest payload, or None

    Row ``[c, c]`` is cell c's local inbox, the other rows its outbox
    contributions.  ``delta_e`` is the width of the staged delta segment
    (``ShardedGraph.delta_width``).
    """
    from ..kernels.edge_relax.ops import edge_relax

    n_keys = n_shards * n_per_shard

    def relax(vstate, senders, sgd):
        table, cnt, pay = edge_relax(
            prog, vstate, senders, sgd["gid"], sgd["csr_key"],
            sgd["csr_src"], sgd["csr_weight"], sgd["csr_dst_gid"],
            n_keys=n_keys, block_e=block_e, skey=sgd.get("csr_skey"),
            delta_e=delta_e)
        shp = (-1, n_shards, n_per_shard)
        return (table.reshape(shp), cnt.reshape(shp),
                None if pay is None else pay.reshape(shp))

    return relax
