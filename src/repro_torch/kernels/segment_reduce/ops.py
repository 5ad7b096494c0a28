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

:func:`gather_segment_sum` is the embedding bag: the rows of a table read
through slot indices and summed by segment.  Its gradient with respect to
the table is dense ([V, D]: each slot's output-gradient row added into its
table row), and it is K5 as well, with the roles swapped: the slots
sorted by table row, each reading the output gradient's row of its
segment.  Both directions are one stable sort and one K5 launch on CUDA
tensors; no atomic, no zeroed output, deterministic bits.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .kernel import segment_sum_sorted
from .ref import row_pointer, segment_sum_ref

__all__ = ["segment_sum", "segment_sum_presorted", "SortedIds", "sort_ids",
           "segment_sum_sorted_by", "gather_segment_sum",
           "gather_segment_sum_plain", "slot_keys", "bag_order",
           "table_order"]


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


# ---------------------------------------------------------------------------
# the embedding bag: a gathered segment sum and its dense table gradient
# ---------------------------------------------------------------------------

def slot_keys(rows, seg_ids, num_segments: int, vocab: int):
    """Each slot's segment as int32, ``num_segments`` where the slot is
    dropped: a row < 0 (a pad) or past the table (>= ``vocab``), or a
    segment id outside [0, N)."""
    live = ((rows >= 0) & (rows < vocab) & (seg_ids >= 0)
            & (seg_ids < num_segments))
    return torch.where(live, seg_ids, num_segments).to(torch.int32)


def live_rows(rows, keys, num_segments: int):
    """The table row each slot reads, row 0 for a dropped slot."""
    return torch.where(keys < num_segments, rows, 0)


def bag_order(rows, keys, num_segments: int) -> SortedIds:
    """The forward's K5 arguments: the slots stably sorted by ``keys``
    (dropped ones, keyed N, at the tail), ``order`` the table row each
    sorted slot reads (a dropped slot's set to row 0: never read)."""
    s = sort_ids(keys, num_segments)
    order = live_rows(rows, keys, num_segments).to(torch.int32)[
        s.order.long()]
    return s._replace(order=order)


def table_order(rows, keys, num_segments: int, vocab: int) -> SortedIds:
    """The table gradient's K5 arguments: the live slots stably sorted by
    table row into ``vocab`` segments (dropped ones keyed ``vocab``, at
    the tail), ``order`` the output-gradient row (the segment) each sorted
    slot reads (a dropped slot's clamped to row 0: never read)."""
    live = keys < num_segments
    s = sort_ids(torch.where(live, rows.to(torch.int32), vocab), vocab)
    order = torch.where(live, keys, 0)[s.order.long()]
    return s._replace(order=order)


class _GatherSegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, rows, keys, num_segments):
        ctx.save_for_backward(rows, keys)
        ctx.shape = (num_segments, table.shape[0])
        s = bag_order(rows, keys, num_segments)
        counts = s.offsets[1:] - s.offsets[:-1]
        ctx.mark_non_differentiable(counts)
        return segment_sum_sorted(table, s.sorted_ids, num_segments,
                                  order=s.order, offsets=s.offsets), counts

    @staticmethod
    def backward(ctx, g, _):
        rows, keys = ctx.saved_tensors
        n, vocab = ctx.shape
        s = table_order(rows, keys, n, vocab)
        return segment_sum_sorted(g.contiguous(), s.sorted_ids, vocab,
                                  order=s.order, offsets=s.offsets), \
            None, None, None


def gather_segment_sum_plain(table, rows, seg_ids, num_segments: int):
    """The plain version of :func:`gather_segment_sum`: the masked row
    gather and ``index_add`` into zeros (so its table gradient is a row
    gather of the output's gradient and ``index_add`` into zeros), and the
    live slots counted by ``bincount``."""
    keys = slot_keys(rows, seg_ids, num_segments, table.shape[0])
    out = segment_sum_ref(table[live_rows(rows, keys, num_segments).long()],
                          keys, num_segments)
    counts = torch.bincount(keys, minlength=num_segments + 1)
    return out, counts[:num_segments].to(torch.int32)


def gather_segment_sum(table, rows, seg_ids, num_segments: int):
    """table [V, D] float32 or bfloat16, rows [E] (table rows; < 0 is a
    pad), seg_ids [E] (any order) -> (sums [N, D], counts [N] int32):
    ``sums[s]`` the sum of ``table[rows[i]]`` over the slots i with
    ``seg_ids[i] == s`` that are not pads, summed in float32, and
    ``counts[s]`` the number of those slots; a slot whose row is >= V or
    whose id lies outside [0, N) is dropped like a pad, forward and
    backward, on both devices.  CUDA tensors run K5 forward
    (:func:`bag_order`; the counts are its row pointer's steps) and for the
    table gradient (:func:`table_order`) or raise; CPU tensors take
    :func:`gather_segment_sum_plain`."""
    if not table.is_cuda:
        return gather_segment_sum_plain(table, rows, seg_ids, num_segments)
    keys = slot_keys(rows, seg_ids, num_segments, table.shape[0])
    return _GatherSegmentSum.apply(table, rows, keys, num_segments)
