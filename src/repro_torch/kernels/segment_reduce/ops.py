"""Public segment sums of the port, with their gradient.

``segment_sum(values, seg_ids, num_segments)`` takes ids in any order: it
sorts them (stable) and runs K5 (:func:`kernel.segment_sum_sorted`), which
reads the values in that order itself.  :func:`sort_ids` does the sort and
the row pointer once for several sums over the same ids (a GNN's
receivers, layer after layer); :func:`segment_sum_sorted_by` takes its
result: one K5 launch a sum, no copy of the values.  Values are float32 or
bfloat16, summed in float32, returned in their dtype.  The gradient with
respect to ``values`` is a row gather of the output's gradient (zero for
dropped ids) — plain PyTorch, as it is XLA in the JAX package
(``repro/kernels/segment_reduce/ops.py :: _bwd``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .kernel import segment_sum_sorted
from .ref import row_pointer

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
        return segment_sum_sorted(values, seg_ids, num_segments)

    @staticmethod
    def backward(ctx, g):
        (seg_ids,) = ctx.saved_tensors
        return _row_gather(g, seg_ids, ctx.num_segments), None, None


def segment_sum_presorted(values, seg_ids, num_segments: int):
    """values [E, F], seg_ids [E] sorted ascending (ids < 0 and >= N
    dropped) -> [N, F] in values' dtype."""
    return _SegmentSum.apply(values, seg_ids.to(torch.int32).contiguous(),
                             num_segments)


class SortedIds(NamedTuple):
    """Segment ids sorted once for several sums: ``order`` [E] int32 the
    stable sort of ``ids``, ``sorted_ids`` [E] int32 (``ids[order]``),
    ``offsets`` [N + 1] int32 their row pointer (``ref.row_pointer``),
    ``ids`` [E] as given."""
    order: torch.Tensor
    sorted_ids: torch.Tensor
    offsets: torch.Tensor
    ids: torch.Tensor
    num_segments: int


def sort_ids(seg_ids, num_segments: int) -> SortedIds:
    """``seg_ids`` [E] (any order) sorted for :func:`segment_sum_sorted_by`."""
    ids, order = torch.sort(seg_ids, stable=True)
    ids = ids.to(torch.int32)
    return SortedIds(order.to(torch.int32), ids,
                     row_pointer(ids, num_segments), seg_ids, num_segments)


class _SortedBySum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, s):
        ctx.save_for_backward(s.ids)
        ctx.num_segments = s.num_segments
        return segment_sum_sorted(values, s.sorted_ids, s.num_segments,
                                  order=s.order, offsets=s.offsets)

    @staticmethod
    def backward(ctx, g):
        (seg_ids,) = ctx.saved_tensors
        return _row_gather(g, seg_ids, ctx.num_segments), None


def segment_sum_sorted_by(values, s: SortedIds):
    """values [E, F] summed by ``s.ids`` into [s.num_segments, F] in values'
    dtype: one K5 launch that reads the rows in ``s.order``."""
    return _SortedBySum.apply(values, s)


def segment_sum(values, seg_ids, num_segments: int):
    """Unsorted segment sum: a stable sort by id, then the sorted kernel."""
    return segment_sum_sorted_by(values, sort_ids(seg_ids, num_segments))
