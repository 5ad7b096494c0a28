"""Plain PyTorch versions of the sorted segment sum.

* :func:`segment_sum_ref` — the oracle of
  ``repro/kernels/segment_reduce/ref.py`` (ids < 0 are dropped).
* :func:`segment_sum_sorted_ref` — the kernel's own order: per segment,
  groups of ``CHUNK`` rows from its first row, each a left fold in row
  order in float32, the groups' values grouped and folded the same way
  until one is left, rounded once to the values' dtype.  Vectorized over
  groups, looping over a group's items.  CPU tensors of the K5 wrapper
  take it.
* :func:`row_offsets` — the row pointer of sorted ids (:func:`row_pointer`
  where no -1 pads the tail).
"""

from __future__ import annotations

import torch

__all__ = ["segment_sum_ref", "segment_sum_sorted_ref", "row_offsets",
           "row_pointer", "CHUNK"]

CHUNK = 64              # L: items a thread folds (kChunk in the kernel)


def _dropped(seg_ids, num_segments: int):
    return torch.where((seg_ids < 0) | (seg_ids >= num_segments),
                       num_segments, seg_ids).long()


def segment_sum_ref(values, seg_ids, num_segments: int):
    """values [E, F] (or [E]), seg_ids [E] int32 (-1 = dropped)."""
    out = torch.zeros((num_segments + 1,) + tuple(values.shape[1:]),
                      dtype=values.dtype, device=values.device)
    out.index_add_(0, _dropped(seg_ids, num_segments), values)
    return out[:num_segments]


def row_pointer(ids, num_segments: int):
    """[N + 1] int32: the number of ``ids`` (int32, sorted ascending) below
    each s in [0, N]."""
    return torch.searchsorted(
        ids, torch.arange(num_segments + 1, dtype=torch.int32,
                          device=ids.device), out_int32=True)


def row_offsets(sorted_ids, num_segments: int):
    """[N + 1] int32: segment s owns the rows [offsets[s], offsets[s + 1])
    of ``sorted_ids`` (sorted ascending; ids < 0 may also pad the tail, as
    the reference pads a stream to its blocks): the ids before offsets[0]
    are < 0, those from offsets[N] on are >= N or tail pads."""
    ids = sorted_ids.to(torch.int32)
    if ids.shape[0]:
        # negative ids after the first id >= 0 are tail pads: sort them last
        head = torch.argmax((ids >= 0).to(torch.int32))
        tail = (ids < 0) & (torch.arange(ids.shape[0], device=ids.device)
                            >= head)
        ids = torch.where(tail, torch.iinfo(torch.int32).max, ids)
    return row_pointer(ids, num_segments)


def _fold_groups(items, first, count, chunk: int):
    """Segment q's items are ``items[first[q]:first[q] + count[q]]``; cut
    them into groups of ``chunk`` (at least one, an empty group is 0) and
    fold each from 0 in order in float32.  Returns the groups' values and
    each segment's first group and group count."""
    dev = items.device
    n_groups = torch.clamp(-(-count // chunk), min=1)
    seg = torch.repeat_interleave(
        torch.arange(first.shape[0], device=dev), n_groups)
    gfirst = torch.cumsum(n_groups, 0) - n_groups
    start = first[seg] + (torch.arange(seg.shape[0], device=dev)
                          - gfirst[seg]) * chunk
    length = torch.clamp(first[seg] + count[seg] - start, 0, chunk)
    acc = torch.zeros((seg.shape[0], items.shape[1]), dtype=torch.float32,
                      device=dev)
    for i in range(int(length.max()) if seg.shape[0] else 0):
        live = (i < length)[:, None]
        x = items[torch.where(live[:, 0], start + i, 0)].float()
        acc = torch.where(live, acc + x, acc)
    return acc, gfirst, n_groups


def segment_sum_sorted_ref(values, seg_ids, num_segments: int, *,
                           order=None, offsets=None, chunk: int = CHUNK):
    """values [E, F] float32 or bfloat16, seg_ids [E] int32 sorted
    ascending (ids < 0 and >= N dropped) -> [N, F] in values' dtype, in
    the kernel's order: each segment's rows folded in groups of ``chunk``,
    the groups' values grouped and folded again until one is left.  With
    ``order`` the stream's row i is ``values[order[i]]``; ``offsets`` as
    :func:`row_offsets` gives it."""
    rows = values if order is None else values.index_select(0, order.long())
    if offsets is None:
        offsets = row_offsets(seg_ids, num_segments)
    first = offsets[:-1].long()
    acc, first, count = _fold_groups(rows, first, offsets[1:].long() - first,
                                     chunk)
    while first.shape[0] and int(count.max()) > 1:
        acc, first, count = _fold_groups(acc, first, count, chunk)
    return acc.to(values.dtype)
