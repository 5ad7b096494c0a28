"""The engine's gather -> emit -> segment-combine step and its sweep
direction (PyTorch port of ``repro.core.relax``).

``make_relax`` builds the relaxation step of a program: every cell's
vertex block + edge streams -> the combined message table per (cell,
destination shard, destination slot).  The cells are a leading batch
dimension, so one kernel launch serves all of them.  Which kernel runs —
the hand-written CUDA one or its plain version — follows the tensors'
device.

``sweep`` picks the direction:

* ``"pull"`` — the dense sweep over the whole destination-sorted stream
  (every edge visited, inactive senders masked); O(E) per sub-iteration.
* ``"push"`` — the frontier-compacted sweep over the source-sorted push
  stream: only the blocks holding an active sender's out-edges are
  gathered.  The compaction capacity is a rung of a power-of-two ladder
  (:func:`push_caps`), chosen per sub-iteration on the host from the
  measured active-block count (:func:`select_bucket`) — the JAX package
  picks the same rung with ``lax.switch``.
* ``"auto"`` — push while the active-block count stays at or under
  ``push_threshold * n_blocks``, dense pull otherwise.

Every sweep returns the same tables bitwise.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["RELAX_SWEEPS", "DEFAULT_PUSH_THRESHOLD", "make_relax",
           "push_caps", "active_push_blocks", "select_bucket"]

# sweep directions understood by make_relax / the engine / the session
RELAX_SWEEPS = ("pull", "push", "auto")

# auto picks push while active blocks <= threshold * total blocks
DEFAULT_PUSH_THRESHOLD = 0.5


def push_caps(n_blocks: int) -> tuple:
    """The power-of-two compaction-bucket ladder for a cell with
    ``n_blocks`` push blocks: (1, 2, 4, ..., n_blocks)."""
    caps = []
    c = 1
    while c < n_blocks:
        caps.append(c)
        c *= 2
    caps.append(n_blocks)
    return tuple(caps)


def active_push_blocks(senders, push_src, block_e: int):
    """Per-cell count of push blocks touched by the sending frontier:
    ``senders`` [S, Np] bool (or lane-stacked [S, L, Np]: the lanes OR
    into one active set), ``push_src`` the matching [S, W] source-sorted
    stream (``-1`` on dead positions).  Returns [S] int64."""
    if senders.ndim == push_src.ndim + 1:
        senders = senders.any(dim=-2)
    ok = push_src >= 0
    act = torch.gather(senders, -1, push_src.clamp(min=0).long()) & ok
    nb = push_src.shape[-1] // block_e
    blk = act.reshape(act.shape[:-1] + (nb, block_e)).any(dim=-1)
    return blk.sum(dim=-1)


def select_bucket(n_active_blocks: int, n_blocks: int, sweep: str,
                  push_threshold: float = DEFAULT_PUSH_THRESHOLD) -> int:
    """The per-sub-iteration direction, on the host: an index into
    :func:`push_caps` (push), or ``len(push_caps(n_blocks))`` (the dense
    pull branch).  ``n_active_blocks`` is the max over cells of the
    active-block count, so no cell's frontier overflows the shared
    bucket."""
    caps = push_caps(n_blocks)
    if sweep == "pull":
        return len(caps)
    count = int(n_active_blocks)
    k = next((i for i, c in enumerate(caps) if c >= count), len(caps) - 1)
    if sweep == "push":
        return k
    if count > max(1, int(push_threshold * n_blocks)):
        return len(caps)
    return k


def make_relax(prog, n_shards: int, n_per_shard: int, block_e: int,
               delta_e: int = 0, sweep: str = "pull") -> Callable:
    """Build the relaxation step for ``prog``.

    The returned function maps (vstate dict of [S, Np] tensors, senders
    [S, Np] bool, the engine's stream dict ``sgd`` of [S, W] ``csr_*``
    tensors (and, for push/auto, the full-width ``push_*`` streams) plus
    ``gid``, and the ``bucket`` from :func:`select_bucket`) to

        table [S, S, Np]  combined messages per (cell, dst shard, dst slot)
        cnt   [S, S, Np]  int32 sending-edge count
        pay   [S, S, Np]  int32 argbest payload, or None

    Row ``[c, c]`` is cell c's local inbox, the other rows its outbox
    contributions.  A laned program's ([S, L, Np] vstate and senders)
    tables are [S, S, L, Np]: the destination shard stays second, so
    ``[c, c]`` is still the local inbox.  ``delta_e`` is the width of the
    staged delta segment the ``csr_*`` streams carry (0 when they end at
    the sorted region).
    ``sweep="pull"`` ignores ``bucket``.
    """
    from ..kernels.edge_relax.ops import edge_relax, edge_relax_push

    if sweep not in RELAX_SWEEPS:
        raise ValueError(f"sweep must be one of {RELAX_SWEEPS}, got {sweep!r}")
    n_keys = n_shards * n_per_shard
    shp = (-1, n_shards, n_per_shard)

    def _cells(a):
        # [S, n_keys] -> [S, S_dst, Np]; laned [S, L, n_keys] ->
        # [S, L, S_dst, Np] -> [S, S_dst, L, Np]
        if prog.lanes:
            return a.reshape(shp[:1] + (prog.lanes,) + shp[1:]).transpose(
                1, 2)
        return a.reshape(shp)

    def _shape(table, cnt, pay):
        return (_cells(table), _cells(cnt),
                None if pay is None else _cells(pay))

    def _dense(vstate, senders, sgd):
        return edge_relax(
            prog, vstate, senders, sgd["gid"], sgd["csr_key"],
            sgd["csr_src"], sgd["csr_weight"], sgd["csr_dst_gid"],
            n_keys=n_keys, block_e=block_e, skey=sgd.get("csr_skey"),
            delta_e=delta_e)

    def relax(vstate, senders, sgd, bucket=None):
        if sweep == "pull":
            return _shape(*_dense(vstate, senders, sgd))
        if bucket is None:
            raise ValueError(
                f"sweep={sweep!r} relaxation needs the per-iteration bucket "
                f"from select_bucket(); only sweep='pull' runs without one")
        caps = push_caps(sgd["push_src"].shape[-1] // block_e)
        if bucket >= len(caps):
            return _shape(*_dense(vstate, senders, sgd))
        return _shape(*edge_relax_push(
            prog, vstate, senders, sgd["gid"], sgd, sgd["csr_key"],
            n_keys=n_keys, block_e=block_e, cap=caps[bucket],
            skey=sgd.get("csr_skey"), delta_e=delta_e))

    return relax
