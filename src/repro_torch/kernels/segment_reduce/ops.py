"""Public segment sums of the port, with their gradient.

``segment_sum(values, seg_ids, num_segments)`` takes ids in any order: it
sorts them once (stable) and runs K5 (:func:`kernel.segment_sum_sorted`)
over the sorted stream, padded to a block multiple with -1 ids.  The
gradient with respect to ``values`` is a row gather of the output's
gradient (zero for dropped ids) — plain PyTorch, as it is XLA in the JAX
package (``repro/kernels/segment_reduce/ops.py :: _bwd``).
"""

from __future__ import annotations

import torch

from .kernel import BLOCK_E, segment_sum_sorted

__all__ = ["segment_sum", "segment_sum_presorted"]


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
        n = ctx.num_segments
        safe = seg_ids.clamp(0, n - 1).long()
        keep = ((seg_ids >= 0) & (seg_ids < n))[:, None]
        gv = torch.where(keep, g[safe], torch.zeros((), dtype=g.dtype,
                                                    device=g.device))
        return gv, None, None


def segment_sum_presorted(values, seg_ids, num_segments: int):
    """values [E, F], seg_ids [E] int32 sorted ascending (-1 pads) ->
    [N, F] in values' dtype."""
    return _SegmentSum.apply(values, seg_ids.to(torch.int32), num_segments)


def segment_sum(values, seg_ids, num_segments: int):
    """Unsorted segment sum: a stable sort by id, then the sorted kernel."""
    order = torch.argsort(seg_ids, stable=True)
    return segment_sum_presorted(values[order], seg_ids[order], num_segments)
