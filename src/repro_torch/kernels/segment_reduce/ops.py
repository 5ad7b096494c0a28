"""Public segment sums of the port, with their gradient.

``segment_sum(values, seg_ids, num_segments)`` takes ids in any order: it
sorts them (stable) and runs K5 (:func:`kernel.segment_sum_sorted`) over
the values gathered in that order, padded to a block multiple with -1
ids.  :func:`sort_ids` does the sort once for several sums over the same
ids (a GNN's receivers, layer after layer), :func:`segment_sum_sorted_by`
takes its result: one row gather and K5 a sum.  The gradient with respect
to ``values`` is a row gather of the output's gradient (zero for dropped
ids) — plain PyTorch, as it is XLA in the JAX package
(``repro/kernels/segment_reduce/ops.py :: _bwd``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .kernel import BLOCK_E, segment_sum_sorted

__all__ = ["segment_sum", "segment_sum_presorted", "SortedIds", "sort_ids",
           "segment_sum_sorted_by"]


def _row_gather(g, seg_ids, n: int):
    """The gradient of a segment sum: row ``seg_ids[i]`` of ``g`` for each
    value row, zero where the id is dropped."""
    safe = seg_ids.clamp(0, n - 1).long()
    keep = ((seg_ids >= 0) & (seg_ids < n))[:, None]
    return torch.where(keep, g[safe], torch.zeros((), dtype=g.dtype,
                                                  device=g.device))


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, seg_ids, num_segments):
        ctx.save_for_backward(seg_ids)
        ctx.num_segments = num_segments
        e = values.shape[0]
        pad = (-e) % BLOCK_E
        v, ids = values.float(), seg_ids
        if pad:
            v = torch.nn.functional.pad(v, (0, 0, 0, pad))
            ids = torch.nn.functional.pad(ids, (0, pad), value=-1)
        out = segment_sum_sorted(v.contiguous(), ids.contiguous(),
                                 num_segments)
        return out.to(values.dtype)

    @staticmethod
    def backward(ctx, g):
        (seg_ids,) = ctx.saved_tensors
        return _row_gather(g, seg_ids, ctx.num_segments), None, None


def segment_sum_presorted(values, seg_ids, num_segments: int):
    """values [E, F], seg_ids [E] int32 sorted ascending (-1 pads) ->
    [N, F] in values' dtype."""
    return _SegmentSum.apply(values, seg_ids.to(torch.int32), num_segments)


class SortedIds(NamedTuple):
    """Segment ids sorted once for several sums: ``order`` [E + pad] the
    stable sort of ``ids`` (its pad rows gather row 0), ``sorted_ids``
    [E + pad] int32 (-1 pads), ``ids`` [E] as given."""
    order: torch.Tensor
    sorted_ids: torch.Tensor
    ids: torch.Tensor
    num_segments: int


def sort_ids(seg_ids, num_segments: int) -> SortedIds:
    """``seg_ids`` [E] (any order) sorted for :func:`segment_sum_sorted_by`,
    padded to a multiple of ``BLOCK_E``."""
    order = torch.argsort(seg_ids, stable=True)
    ids = seg_ids[order].to(torch.int32)
    pad = (-seg_ids.shape[0]) % BLOCK_E
    if pad:
        order = torch.nn.functional.pad(order, (0, pad))
        ids = torch.nn.functional.pad(ids, (0, pad), value=-1)
    return SortedIds(order, ids, seg_ids, num_segments)


class _SortedBySum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, order, sorted_ids, seg_ids, num_segments):
        ctx.save_for_backward(seg_ids)
        ctx.num_segments = num_segments
        v = values.index_select(0, order).float()
        return segment_sum_sorted(v, sorted_ids, num_segments).to(
            values.dtype)

    @staticmethod
    def backward(ctx, g):
        (seg_ids,) = ctx.saved_tensors
        return (_row_gather(g, seg_ids, ctx.num_segments), None, None, None,
                None)


def segment_sum_sorted_by(values, s: SortedIds):
    """values [E, F] summed by ``s.ids`` into [s.num_segments, F] in values'
    dtype: one gather in ``s.order``, then K5."""
    return _SortedBySum.apply(values, s.order, s.sorted_ids, s.ids,
                              s.num_segments)


def segment_sum(values, seg_ids, num_segments: int):
    """Unsorted segment sum: a stable sort by id, then the sorted kernel."""
    return segment_sum_sorted_by(values, sort_ids(seg_ids, num_segments))
