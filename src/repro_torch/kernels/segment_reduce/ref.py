"""Plain PyTorch versions of the sorted segment sum.

* :func:`segment_sum_ref` — the oracle of
  ``repro/kernels/segment_reduce/ref.py`` (ids < 0 are dropped).
* :func:`segment_sum_sorted_ref` — the kernel's own algorithm: per
  ``BLOCK_E``-row block, the rows of each run of equal ids summed in row
  order, then each run's sum added into the output.  CPU tensors of the K5
  wrapper take it.
"""

from __future__ import annotations

import torch

__all__ = ["segment_sum_ref", "segment_sum_sorted_ref", "BLOCK_E"]

BLOCK_E = 128                            # rows per block, as in the kernel


def _dropped(seg_ids, num_segments: int):
    return torch.where((seg_ids < 0) | (seg_ids >= num_segments),
                       num_segments, seg_ids).long()


def segment_sum_ref(values, seg_ids, num_segments: int):
    """values [E, F] (or [E]), seg_ids [E] int32 (-1 = dropped)."""
    out = torch.zeros((num_segments + 1,) + tuple(values.shape[1:]),
                      dtype=values.dtype, device=values.device)
    out.index_add_(0, _dropped(seg_ids, num_segments), values)
    return out[:num_segments]


def segment_sum_sorted_ref(values, seg_ids, num_segments: int):
    """values [E, F] f32, seg_ids [E] int32 sorted ascending (-1 and ids
    >= N dropped), E % BLOCK_E == 0 -> [N, F] f32."""
    e, f = values.shape
    nb = e // BLOCK_E
    v = values.float().reshape(nb, BLOCK_E, f)
    ids = _dropped(seg_ids, num_segments).reshape(nb, BLOCK_E)
    out = torch.zeros((num_segments + 1, f), dtype=torch.float32,
                      device=values.device)
    acc = torch.zeros((nb, f), dtype=torch.float32, device=values.device)
    for i in range(BLOCK_E):
        cur = ids[:, i]
        if i:
            acc = torch.where((cur != ids[:, i - 1])[:, None], 0.0, acc)
        acc = acc + torch.where((cur < num_segments)[:, None], v[:, i], 0.0)
        last = ids[:, i + 1] != cur if i + 1 < BLOCK_E else None
        # a run's sum goes out at its last row (others to the spare row)
        at = cur if last is None else torch.where(last, cur, num_segments)
        out.index_add_(0, at, acc)
    return out[:num_segments]
