"""GPipe pipeline parallelism over a mesh axis (the port of
``repro/dist/pipeline.py``).

One stage per rank along ``axis``; micro-batches stream through the
stages, the activation passing to the next stage by ``send``/``recv``
each tick.  The schedule runs ``n_micro + n_stages - 1`` ticks; the
classic bubble fraction is ``(S - 1) / (M + S - 1)``.  The reference's
``shard_map`` body becomes the per-rank function.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..launch.mesh import host_staged
from ..optim.optimizers import tree_map

__all__ = ["make_pipeline_fn", "bubble_fraction"]


def bubble_fraction(n_micro: int, n_stages: int) -> float:
    """Idle fraction of the GPipe schedule (fill + drain)."""
    return (n_stages - 1) / (n_micro + n_stages - 1)


def make_pipeline_fn(mesh, stage_fn, n_stages: int, n_micro: int,
                     axis: str = "pod"):
    """Build the per-rank ``(ws, xs [M, ...]) -> ys [M, ...]`` running
    ``stage_fn(w_s, x)`` for stages s = 0..S-1 in sequence over every
    micro-batch; every rank of the ``axis`` group calls it.

    ``ws`` is stage-sharded over ``axis``: a DTensor split on dim 0 over
    that mesh dim, or the rank's own ``[1, ...]`` block, or a tree (nested
    dicts) of them (``stage_fn`` then gets the tree of ``[0]``s); ``xs``
    is the same on every rank (stage 0 injects the micro-batches, the
    last stage writes the outputs, and a sum over the group leaves ``ys``
    on every rank)."""
    S, M = n_stages, n_micro
    dim = list(mesh.mesh_dim_names).index(axis)
    if mesh.size(dim) != S:
        raise ValueError(f"{S} stages on a mesh axis {axis!r} of "
                         f"{mesh.size(dim)} ranks")
    group = mesh.get_group(dim)
    ranks = dist.get_process_group_ranks(group)

    def stage_weights(leaf):
        local = leaf.to_local() if isinstance(leaf, DTensor) else leaf
        if local.shape[0] != 1:
            raise ValueError(f"a rank holds one stage's weights [1, ...]; "
                             f"got {tuple(local.shape)}")
        return local[0]

    def per_rank(ws, xs):
        w = tree_map(stage_weights, ws)
        stage = mesh.get_local_rank(dim)
        buf = torch.zeros_like(xs[0])     # activation from stage - 1
        ys = torch.zeros_like(xs)
        for t in range(M + S - 1):
            out = stage_fn(w, xs[min(t, M - 1)] if stage == 0 else buf)
            if stage == S - 1 and t >= S - 1:
                ys[t - (S - 1)] = out
            buf = _shift(out, stage, S, ranks, group)
        # only the last stage wrote outputs; a sum replicates them
        dist.all_reduce(ys, group=group)
        return ys

    return per_rank


def _shift(out, stage: int, n_stages: int, ranks, group):
    """Send ``out`` to the next stage and receive the previous stage's
    (the reference's ``ppermute``, without the last stage's wrap to the
    first, which nothing reads)."""
    buf = torch.empty_like(out)
    ops = []
    if stage + 1 < n_stages:
        ops.append(("send", out, ranks[stage + 1]))
    if stage > 0:
        ops.append(("recv", buf, ranks[stage - 1]))
    if not ops:
        return buf
    host_staged(_p2p, *[t for _, t, _ in ops], ops=ops, group=group)
    return buf if stage > 0 else torch.zeros_like(out)


def _p2p(*tensors, ops, group):
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend if kind == "send" else dist.irecv, t, peer,
                   group=group)
        for t, (kind, _, peer) in zip(tensors, ops)])
    for w in works:
        w.wait()
